"""Seeded raw inputs for a configuration, one file at a time.

The generators of the five kinds are a frozen copy of the port's
``utils/corpus.py`` (``_text`` ... ``_random``, line for line), so that a
later change to the program's corpus cannot move the benchmark's inputs.

A configuration lists its files as ``[name, kind, size]``; each of its
``replicas`` gets its own content. File ``i`` of the expanded list draws
from ``numpy.random.default_rng([seed, i])``, so one seed gives the same
bytes whatever the number of workers, and every seed gives the same sizes and
kinds in the same order.
"""

from __future__ import annotations

import numpy as np

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


def layout(config: dict) -> list[tuple[str, str, int]]:
    """The configuration's files, expanded over its replicas, in batch
    order: ``(name, kind, size)``, replica ``r`` of a file named
    ``name#r``."""
    out = []
    for r in range(int(config.get("replicas", 1))):
        for name, kind, size in config["files"]:
            if kind not in _GEN:
                raise ValueError(f"unknown kind {kind!r} of {name!r}")
            out.append((f"{name}#{r}", kind, int(size)))
    return out


def seed_key(seed: int) -> int:
    """``seed`` as the non-negative integer that seeds numpy (any whole
    number, negative or past 64 bits, is taken modulo 2**64)."""
    return int(seed) % (1 << 64)


def make_file(kind: str, size: int, seed: int, index: int) -> bytes:
    """File ``index`` of a batch: ``size`` bytes of ``kind``."""
    rng = np.random.default_rng([seed_key(seed), index])
    return _GEN[kind](rng, size)
