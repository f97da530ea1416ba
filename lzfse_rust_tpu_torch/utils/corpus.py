"""A seeded serving corpus, generated in the repository.

Raw data of five kinds, made with ``numpy.random.default_rng(seed)`` and
encoded with the native encoder, so that every LZFSE block type occurs:

* ``text``   -- a Zipf-distributed word stream with punctuation and line
  breaks (FSE blocks, match-heavy);
* ``urls``   -- one URL per line: Zipf-chosen hosts and path segments
  (FSE blocks, many short matches);
* ``html``   -- markup: tags, attributes and text from the same kind of
  vocabulary (FSE blocks, long repeated matches);
* ``binary`` -- slowly varying little-endian counters, fixed-schema
  records and small-alphabet bytes, with random runs between them (FSE
  blocks, literal-heavy);
* ``random`` -- incompressible bytes, standing in for compressed media
  (FSE blocks, literals only; under 4 KiB a RAW block).

The serving batch draws the kinds in the byte shares of the Snappy
benchmark corpus (``SNAPPY_BYTES``), the files that the JAX package's
``bench.py`` replicates 48 times into its serving batch.

Other inputs under 4 KiB encode as LZVN blocks, and ``b"bvx$"`` is the
empty container (the encoder itself writes a zero-length RAW block).
Every container draws its own vocabulary and content, so no two
containers repeat each other.
"""

from __future__ import annotations

import numpy as np

KINDS = ("text", "urls", "html", "binary", "random")
EMPTY = b"bvx$"

# Raw bytes of each file of the Snappy benchmark corpus, by the kind that
# stands in for it. 48 replicas of these twelve files are bench.py's
# serving batch: 141,241,872 raw bytes.
SNAPPY_BYTES = {
    "text": {"alice29.txt": 152089, "asyoulik.txt": 125179,
             "lcet10.txt": 426754, "plrabn12.txt": 481861,
             "Mark.Twain-Tom.Sawyer.txt": 14168},
    "urls": {"urls.10K": 702087},
    "html": {"html": 102400, "html_x_4": 409600},
    "binary": {"geo.protodata": 118588, "kppkn.gtb": 184320},
    "random": {"fireworks.jpeg": 123093, "paper-100k.pdf": 102400},
}
_KIND_BYTES = np.array([sum(SNAPPY_BYTES[k].values()) for k in KINDS], float)
# probability of each kind per serving-batch container, in KINDS order
MIX = tuple(float(x) for x in _KIND_BYTES / _KIND_BYTES.sum())
SERVING_BYTES = 128 << 20

_LETTERS = np.frombuffer(b"etaoinshrdlcumwfgypbvkjxqz", np.uint8)
_LETTER_P = np.array([12.7, 9.1, 8.2, 7.5, 7.0, 6.7, 6.3, 6.1, 6.0, 4.3, 4.0,
                      2.8, 2.8, 2.4, 2.4, 2.2, 2.0, 2.0, 1.9, 1.5, 1.0, 0.8,
                      0.2, 0.2, 0.1, 0.1])
_LETTER_P = _LETTER_P / _LETTER_P.sum()
_TAGS = [b"div", b"span", b"a", b"p", b"li", b"td", b"tr", b"img", b"ul",
         b"table", b"section", b"h2", b"em", b"strong", b"meta", b"link"]
_ATTRS = [b"class", b"id", b"href", b"style", b"src", b"title", b"rel",
          b"data-id", b"alt", b"name"]


def _vocab(rng, n_words: int) -> list[bytes]:
    lens = rng.integers(1, 11, n_words)
    letters = rng.choice(_LETTERS, size=int(lens.sum()), p=_LETTER_P)
    cut = np.cumsum(lens)[:-1]
    return [w.tobytes() for w in np.split(letters, cut)]


def _join(tokens: list[bytes], idx: np.ndarray) -> bytes:
    """``b"".join(tokens[i] for i in idx)`` without a Python loop over idx."""
    flat = np.frombuffer(b"".join(tokens), np.uint8)
    lens = np.fromiter((len(t) for t in tokens), np.int64, len(tokens))
    starts = np.concatenate(([0], np.cumsum(lens)[:-1]))
    n = lens[idx]
    pos = np.repeat(starts[idx] - np.concatenate(([0], np.cumsum(n)[:-1])), n)
    return flat[pos + np.arange(int(n.sum()))].tobytes()


def _zipf_idx(rng, n_tokens: int, n: int, a: float = 1.1) -> np.ndarray:
    return (rng.zipf(a, n) - 1) % n_tokens


def _text(rng, n_bytes: int) -> bytes:
    vocab = _vocab(rng, int(rng.integers(2000, 8000)))
    seps = [b" "] * 12 + [b", ", b". ", b".\n", b"\n", b"; ", b"! ", b"? "]
    tokens = ([w + b" " for w in vocab]
              + [vocab[i] + s for i in range(64) for s in seps])
    idx = _zipf_idx(rng, len(tokens), n_bytes // 5 + 64)
    return _join(tokens, idx)[:n_bytes]


def _urls(rng, n_bytes: int) -> bytes:
    vocab = _vocab(rng, int(rng.integers(1000, 4000)))
    schemes = (b"http://", b"http://www.", b"https://")
    tlds = (b".com", b".org", b".net", b".edu", b".co.uk", b".de", b".gov")
    hosts = [schemes[int(rng.integers(len(schemes)))]
             + vocab[int(rng.integers(len(vocab)))]
             + tlds[int(rng.integers(len(tlds)))]
             for _ in range(int(rng.integers(100, 600)))]
    segs = [b"/" + w for w in vocab]
    ends = [b"\n", b"/\n", b".html\n", b".htm\n", b".php\n"] + [
        b"?id=%d\n" % int(rng.integers(100_000)) for _ in range(32)]
    # each line: a host, 1 to 5 path segments, an ending
    n_lines = n_bytes // 20 + 16
    per = rng.integers(1, 6, n_lines) + 2
    first = np.concatenate(([0], np.cumsum(per)[:-1]))
    idx = len(hosts) + _zipf_idx(rng, len(segs), int(per.sum()))
    idx[first] = _zipf_idx(rng, len(hosts), n_lines)
    idx[first + per - 1] = (len(hosts) + len(segs)
                            + rng.integers(0, len(ends), n_lines))
    return _join(hosts + segs + ends, idx)[:n_bytes]


def _html(rng, n_bytes: int) -> bytes:
    vocab = _vocab(rng, int(rng.integers(500, 3000)))
    tokens: list[bytes] = []
    for _ in range(400):
        tag = _TAGS[int(rng.integers(len(_TAGS)))]
        attrs = b"".join(
            b" " + _ATTRS[int(rng.integers(len(_ATTRS)))] + b'="'
            + vocab[int(rng.integers(len(vocab)))] + b"-"
            + str(int(rng.integers(10_000))).encode() + b'"'
            for _ in range(int(rng.integers(0, 4))))
        tokens.append(b"<" + tag + attrs + b">")
        tokens.append(b"</" + tag + b">\n")
    tokens += [w + b" " for w in vocab]
    idx = _zipf_idx(rng, len(tokens), n_bytes // 6 + 64, 1.05)
    return _join(tokens, idx)[:n_bytes]


def _binary(rng, n_bytes: int) -> bytes:
    parts = []
    total = 0
    while total < n_bytes:
        kind = int(rng.integers(4))
        n = int(rng.integers(256, 16384))
        if kind == 0:      # slowly varying counters
            a = np.cumsum(rng.integers(0, 4, n)).astype("<u4")
        elif kind == 1:    # fixed-schema records: id, type, flags, value
            a = np.zeros(n, [("id", "<u4"), ("type", "<u2"), ("flags", "<u2"),
                             ("value", "<f4"), ("pad", "<u4")])
            a["id"] = int(rng.integers(1 << 20)) + np.arange(n)
            a["type"] = rng.integers(0, int(rng.integers(2, 12)), n)
            a["flags"] = rng.integers(0, 4, n) << 4
            a["value"] = rng.choice(rng.uniform(0, 1000, 16), n)
        elif kind == 2:    # small-alphabet bytes
            a = rng.integers(0, int(rng.integers(2, 24)), n * 4, np.uint8)
        else:              # random run
            a = rng.integers(0, 256, n, np.uint8)
        b = a.tobytes()
        parts.append(b)
        total += len(b)
    return b"".join(parts)[:n_bytes]


def _random(rng, n_bytes: int) -> bytes:
    return rng.bytes(n_bytes)


_GEN = {"text": _text, "urls": _urls, "html": _html, "binary": _binary,
        "random": _random}


def make_raw(kind: str, n_bytes: int, rng: np.random.Generator) -> bytes:
    """``n_bytes`` of raw data of the given kind."""
    return _GEN[kind](rng, n_bytes)


def encode(raw: bytes) -> bytes:
    """Encode with the native encoder, built from the in-repo source."""
    from ..runtime.build import native_runtime
    return native_runtime().encode_bytes(raw)


def _with_small(raws: list[bytes], rng) -> list[tuple[bytes, bytes]]:
    """Encode ``raws`` plus two LZVN inputs, one RAW input and the empty
    input, add the bare ``b"bvx$"`` container, and shuffle."""
    raws = raws + [make_raw("text", int(rng.integers(300, 3000)), rng),
                   make_raw("html", int(rng.integers(300, 3000)), rng),
                   make_raw("random", int(rng.integers(500, 4000)), rng),
                   b""]
    pairs = [(r, encode(r)) for r in raws] + [(b"", EMPTY)]
    return [pairs[i] for i in rng.permutation(len(pairs))]


def serving_batch(seed: int = 0, min_bytes: int = SERVING_BYTES,
                  lo: int = 16 << 10,
                  hi: int = 4 << 20) -> list[tuple[bytes, bytes]]:
    """``(raw, container)`` pairs: containers of ``lo`` to ``hi`` raw bytes
    (log-uniform sizes, kinds drawn with probabilities ``MIX``) until
    ``min_bytes`` raw, plus the small containers of ``_with_small``."""
    rng = np.random.default_rng(seed)
    raws: list[bytes] = []
    total = 0
    while total < min_bytes:
        n = int(np.exp(rng.uniform(np.log(lo), np.log(hi))))
        kind = KINDS[int(rng.choice(len(KINDS), p=MIX))]
        raws.append(make_raw(kind, n, rng))
        total += n
    return _with_small(raws, rng)


def kind_batch(kind: str, seed: int = 0, min_bytes: int = 24 << 20,
               lo: int = 16 << 10,
               hi: int = 4 << 20) -> list[tuple[bytes, bytes]]:
    """``(raw, container)`` pairs of one kind only: containers of ``lo`` to
    ``hi`` raw bytes (log-uniform sizes) until ``min_bytes`` raw."""
    rng = np.random.default_rng(seed)
    pairs: list[tuple[bytes, bytes]] = []
    total = 0
    while total < min_bytes:
        raw = make_raw(kind, int(np.exp(rng.uniform(np.log(lo), np.log(hi)))),
                       rng)
        pairs.append((raw, encode(raw)))
        total += len(raw)
    return pairs


def small_batch(seed: int = 0, n_fse: int = 6, lo: int = 6_000,
                hi: int = 40_000) -> list[tuple[bytes, bytes]]:
    """A small mixed batch for the CPU tests: ``n_fse`` FSE containers of
    ``lo`` to ``hi`` raw bytes (text, html and binary in turn) plus the
    small containers of ``_with_small``."""
    rng = np.random.default_rng(seed)
    raws = [make_raw(("text", "html", "binary")[i % 3],
                     int(rng.integers(lo, hi)), rng) for i in range(n_fse)]
    return _with_small(raws, rng)
