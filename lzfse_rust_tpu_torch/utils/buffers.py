"""Host buffers of the engines: reused int32 staging and download buffers,
pinned where they feed a card (``models/decoder.py``,
``models/encoder.py``)."""

from __future__ import annotations

import torch


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def host_buffer(old: torch.Tensor | None, n_words: int,
                pinned: bool) -> torch.Tensor:
    """A host int32 buffer of at least n_words: ``old`` when it is big
    enough, else a new one (1 MiB steps), pinned when it feeds a card."""
    if old is not None and old.numel() >= n_words:
        return old
    cap = _round_up(max(n_words, 1), 1 << 18)
    return torch.empty(cap, dtype=torch.int32, pin_memory=pinned)


def download(outs, buf: torch.Tensor | None, cuda: bool):
    """Copy int32 device tensors into one host buffer (``buf`` reused when
    big enough; pinned, with ``non_blocking`` copies, from a card). Returns
    (buffer, numpy views shaped as ``outs``); on a card the views are valid
    once the stream has passed the copies."""
    return download_groups([[t] for t in outs], buf, cuda)


def download_groups(groups, buf: torch.Tensor | None, cuda: bool):
    """``download`` of groups of int32 tensors (a group's tensors may lie on
    different devices): each group's tensors land one after another, so
    its view is their concatenation along dim 0. Returns (buffer, one
    numpy view per group)."""
    buf = host_buffer(buf, sum(t.numel() for g in groups for t in g), cuda)
    host = buf.numpy()
    pieces, o = [], 0
    for g in groups:
        start = o
        for t in g:
            n = t.numel()
            buf[o:o + n].copy_(t.reshape(-1), non_blocking=cuda)
            o += n
        pieces.append(host[start:o].reshape(-1, *g[0].shape[1:]))
    return buf, pieces
