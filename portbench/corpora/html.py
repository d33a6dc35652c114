"""The ``html`` corpus: web-crawl pages with planted near-duplicates
(``bench_configs._html_corpus``'s classes and edit budgets), against a
stored index of the same make-up.

A page is ``page_bytes`` long: ``<html><head><title>p</title></head>
<body>``, words of the vocabulary each followed by a space, as many as
fit, ``</body></html>``, then spaces.  The vocabulary is ``vocabulary``
distinct words of ``word_letters`` lower-case letters (lengths drawn
uniformly), drawn from ``store_seed``.

The store: ``store_pages`` pages in groups of four, group ``b`` drawn
from ``(store_seed, b)`` alone, so that any stored page can be made
again on its own (page ``j`` is ``store_groups(c, b, b + 1)[j % 4]``
with ``b = j // 4``): page ``4 b`` is a base page, its words drawn
uniformly, and pages ``4 b + 1`` to ``4 b + 3`` are made from it, each
of the class ``stored_class(j)``: the store's non-base pages in turn
take ``STORE_CYCLE``, the classes at ``odds`` every five pages.  The
classes, each drawn under ``(store_seed, j)``:

- ``span``: ``page_bytes // 3200`` runs of 16 random letters at random
  places (~0.5% of the bytes);
- ``scattered``: ``page_bytes // 200`` single random letters at
  distinct places (the same byte budget, five times the shingles);
- ``shuffle``: the base's words in another order (the same words,
  almost no shared 5-grams).

The pool: ``segments`` pages, each of one of ``CLASSES`` over a stored
base group of its own (``made.plans[i]``: class, group), the same for
every seed: each class takes its share ``odds`` of the pool, rounded
by largest remainder, in an order and over groups drawn from
``plan_seed``; the run's seed draws the edits and the shuffles.
"""

from __future__ import annotations

import functools

import numpy as np

HEAD = b"<html><head><title>p</title></head><body>"
TAIL = b"</body></html>"
CLASSES = ("span", "scattered", "shuffle")
# The classes of the store's non-base pages in turn: 40/40/20.
STORE_CYCLE = (0, 1, 0, 1, 2)
SPAN = 16
_LETTERS = (97, 123)
_M32 = 0xFFFFFFFF
# The store's draws: word ids, shuffle keys, span places and letters,
# scattered keys and letters.
_WORD, _SHUFFLE, _SPAN_AT, _SPAN_LETTER, _SCATTER_KEY, _SCATTER_LETTER = \
    range(6)


def _rng(*key: int) -> np.random.Generator:
    return np.random.default_rng(np.random.SeedSequence(
        [k % (1 << 64) for k in key]))


class Vocabulary:
    """Every word and a space after it, end to end in ``flat``: word ``j``
    is ``flat[start[j]:start[j] + lens[j]]``."""

    def __init__(self, size: int, letters: tuple[int, int], seed: int):
        rng = _rng(seed, 1)
        lo, hi = letters
        words: dict[bytes, None] = {}
        while len(words) < size:
            n = rng.integers(lo, hi + 1)
            words.setdefault(rng.integers(*_LETTERS, n, dtype=np.uint8)
                             .tobytes() + b" ", None)
        self.flat = np.frombuffer(b"".join(words), dtype=np.uint8).copy()
        self.lens = np.array([len(w) for w in words], dtype=np.int64)
        self.start = np.cumsum(self.lens) - self.lens


@functools.lru_cache(maxsize=4)
def vocabulary(size: int, letters: tuple[int, int], seed: int) -> Vocabulary:
    return Vocabulary(size, letters, seed)


def _vocabulary(c: dict) -> Vocabulary:
    return vocabulary(c["vocabulary"], tuple(c["word_letters"]),
                      c["store_seed"])


def _mix(x):
    """A 32-bit integer mixer (xor-shift-multiply) on int64 values below
    2**32, in torch: each product stays below 2**63, so every device
    computes the same bits."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x2C1B3C6D) & _M32
    return x ^ (x >> 16)


def _hash(seed: int, groups, stream: int, index):
    """The store's draw ``index`` of ``stream`` for each of ``groups``:
    a pure function of (seed, group, stream, index), below 2**32."""
    import torch

    s = _mix(torch.tensor(seed & _M32, dtype=torch.int64))
    return _mix(_mix((s ^ groups) & _M32) ^ ((stream << 24) | index))


def render(words: Vocabulary, ids, counts, page_bytes: int):
    """uint8 (len(counts), page_bytes) torch rows: row ``i`` is the page
    of the next ``counts[i]`` word ids of ``ids`` (which fit), on the
    device ``ids`` lies on."""
    import torch

    dev = ids.device

    def on(a):
        return torch.as_tensor(a, device=dev)

    # Byte g of all the bodies end to end lies in token t, which starts at
    # at[t]: it goes to row[t] + g of the rows and comes from word ids[t]'s
    # start - at[t] + g of the vocabulary.
    lens = on(words.lens)[ids]
    at = torch.cumsum(lens, 0) - lens
    first = torch.cumsum(counts, 0) - counts
    starts = torch.arange(len(counts), device=dev) * page_bytes + len(HEAD)
    step = torch.arange(int(lens.sum()), device=dev)
    out = torch.full((len(counts) * page_bytes,), ord(" "), dtype=torch.uint8,
                     device=dev)
    out[torch.repeat_interleave(torch.repeat_interleave(
        starts - at[first], counts), lens) + step] = on(words.flat)[
        torch.repeat_interleave(on(words.start)[ids] - at, lens) + step]
    last = first + counts - 1
    ends = starts + at[last] + lens[last] - at[first]
    out[(ends[:, None] + torch.arange(len(TAIL), device=dev)).reshape(-1)] \
        = on(np.frombuffer(TAIL, np.uint8).copy()).repeat(len(counts))
    out = out.view(len(counts), page_bytes)
    out[:, :len(HEAD)] = on(np.frombuffer(HEAD, np.uint8).copy())
    return out


def _base(c: dict, lo: int, hi: int, device):
    """The word ids of groups ``lo`` to ``hi - 1``'s base pages: (groups,
    tokens) torch ids, and how many of each row fit."""
    import torch

    words = _vocabulary(c)
    room = c["page_bytes"] - len(HEAD) - len(TAIL)
    b = torch.arange(lo, hi, device=device)[:, None]
    ids = _hash(c["store_seed"], b, _WORD,
                torch.arange(room // 3, device=device)) % len(words.lens)
    fit = (torch.cumsum(torch.as_tensor(words.lens, device=device)[ids], 1)
           <= room).sum(1)
    return ids, fit


def _shuffle(ids, fit, seed: int, key):
    """Each row's words that fit in another order, first in the row:
    ordered by a draw of their own under ``(seed, key)`` (unique: the
    draw above the place)."""
    import torch

    t = torch.arange(ids.shape[1], device=ids.device)
    order = torch.where(t < fit[:, None],
                        (_hash(seed, key, _SHUFFLE, t) << 16) | t, 1 << 62)
    return torch.gather(ids, 1, torch.argsort(order, dim=1))


def _span_edit(pages, seed: int, key):
    """``page_bytes // 3200`` runs of ``SPAN`` letters at places drawn
    under ``(seed, key)``, one run after another (a later run over an
    earlier)."""
    import torch

    g, n = pages.shape
    dev = pages.device
    k = max(n // (200 * SPAN), 1)
    at = _hash(seed, key, _SPAN_AT, torch.arange(k, device=dev)) % (n - SPAN)
    letters = (_hash(seed, key, _SPAN_LETTER, torch.arange(
        k * SPAN, device=dev)) % 26 + _LETTERS[0]).to(torch.uint8)
    rows = torch.arange(g, device=dev)[:, None]
    out = pages.clone()
    for r in range(k):
        out[rows, at[:, r:r + 1] + torch.arange(SPAN, device=dev)] = \
            letters[:, r * SPAN:(r + 1) * SPAN]
    return out


def _scattered_edit(pages, seed: int, key):
    """``page_bytes // 200`` letters at the distinct places of the least
    draws under ``(seed, key)`` (unique: the place below the draw), each
    place's letter a draw of its own."""
    import torch

    g, n = pages.shape
    dev = pages.device
    place = torch.arange(n, device=dev)
    where = torch.topk((_hash(seed, key, _SCATTER_KEY, place) << 16) | place,
                       max(n // 200, 1), dim=1, largest=False).indices
    out = pages.clone()
    out[torch.arange(g, device=dev)[:, None], where] = (
        _hash(seed, key, _SCATTER_LETTER, where) % 26
        + _LETTERS[0]).to(torch.uint8)
    return out


def stored_class(j):
    """The class (index into ``CLASSES``) of stored pages ``j`` (a torch
    tensor of non-base pages, ``j % 4`` from 1 to 3)."""
    import torch

    cycle = torch.tensor(STORE_CYCLE, device=j.device)
    return cycle[(3 * (j // 4) + j % 4 - 1) % len(STORE_CYCLE)]


def store_groups(c: dict, lo: int, hi: int, device=None) -> np.ndarray:
    """Groups ``lo`` to ``hi - 1`` of the store: uint8 (4 (hi - lo),
    page_bytes), each group's base page and then its three pages made
    from it (stored pages ``4 lo`` on), made on ``device`` (the CPU
    where none is given)."""
    import torch

    dev = torch.device(device or "cpu")
    seed, size = c["store_seed"], c["page_bytes"]
    ids, fit = _base(c, lo, hi, dev)
    g = hi - lo
    j = 4 * torch.arange(lo, hi, device=dev)[:, None] \
        + torch.arange(1, 4, device=dev)
    kind = stored_class(j)
    at = [torch.nonzero(kind == k, as_tuple=True) for k in range(3)]
    rows, slot = at[2]
    shuffled = _shuffle(ids[rows], fit[rows], seed, j[rows, slot][:, None])
    t = torch.arange(ids.shape[1], device=dev)
    pages = render(_vocabulary(c), torch.cat(
        [ids[t < fit[:, None]], shuffled[t < fit[rows][:, None]]]),
        torch.cat([fit, fit[rows]]), size)
    base = pages[:g]
    out = torch.empty((g, 4, size), dtype=torch.uint8, device=dev)
    out[:, 0] = base
    out[rows, slot + 1] = pages[g:]
    for k, edit in ((0, _span_edit), (1, _scattered_edit)):
        rows, slot = at[k]
        out[rows, slot + 1] = edit(base[rows], seed, j[rows, slot][:, None])
    return out.reshape(-1, size).cpu().numpy()


def _quota(odds, n: int) -> np.ndarray:
    """``n`` split by ``odds``, rounded by largest remainder (ties to the
    first)."""
    want = np.asarray(odds, dtype=np.float64) * n
    out = np.floor(want).astype(np.int64)
    rest = np.argsort(-(want - out), kind="stable")[:n - out.sum()]
    out[rest] += 1
    return out


def setup(made, plan: np.random.Generator, shared: np.random.Generator
          ) -> None:
    c = made.c
    if c["page_bytes"] > made.segment_bytes:
        raise ValueError(f"pages of {c['page_bytes']} bytes exceed "
                         f"segments of {made.segment_bytes}")
    groups = c["store_pages"] // 4
    if made.segments > groups:
        raise ValueError(f"{made.segments} pool pages need as many of the "
                         f"store's {groups} groups")
    cycle = np.bincount(STORE_CYCLE, minlength=len(CLASSES))
    if not np.allclose(cycle / cycle.sum(), c["odds"]):
        raise ValueError(f"the store's classes come at {cycle.tolist()} in "
                         f"{cycle.sum()}, not at the odds {c['odds']}")
    kinds = plan.permutation(np.repeat(np.arange(len(CLASSES)),
                                       _quota(c["odds"], made.segments)))
    bases = plan.choice(groups, size=made.segments, replace=False)
    made.plans = [(CLASSES[int(k)], int(b)) for k, b in zip(kinds, bases)]
    _vocabulary(c)


def segment(made, i: int, rng: np.random.Generator) -> bytes:
    """Pool page ``i``: its stored group's base page, edited or shuffled
    under a draw of the run's seed."""
    import torch

    c = made.c
    kind, b = made.plans[i]
    seed, key = int(rng.integers(1 << 32)), torch.tensor([[i]])
    ids, fit = _base(c, b, b + 1, torch.device("cpu"))
    if kind == "shuffle":
        ids = _shuffle(ids, fit, seed, key)
    page = render(_vocabulary(c), ids[0, :int(fit[0])], fit, c["page_bytes"])
    if kind == "span":
        page = _span_edit(page, seed, key)
    elif kind == "scattered":
        page = _scattered_edit(page, seed, key)
    return page[0].numpy().tobytes()
