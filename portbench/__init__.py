"""The benchmark of ``fastdfs_tpu_torch``: see ``run.py`` and PERF.md."""
