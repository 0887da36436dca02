"""Sparse compaction of kernel outputs (torch).

The port of `select_nonzero_words` and `select_set_bits` from the JAX
package's compaction module. There they are a rank/select written in jnp
because `jnp.nonzero` lowers badly on a TPU; on the card and on the CPU
`torch.nonzero` does the same job directly. The JAX contract is kept: the
first `cap` nonzero words (set bits) in index order, a `live` mask, and
word indices filled with the array size past the count (what the JAX
bitap engine applies after the call, `jnp.where(live, widx, size)`).
`select_set_bits` is the plain version of kernel S1
(`candidate_kernels.cand_select`), which the fingerprint and cascade
engines run on the card; `select_matches` compacts the verify stages'
match slots.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..utils import log
from .bitap_kernels import popcount32, u32


def select_nonzero_words(
    flat: torch.Tensor, cap: int
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, indices[cap], values[cap], live[cap]) of the first ``cap``
    nonzero words of the 1-D tensor ``flat``, in index order.

    ``count`` counts every nonzero word, also those past ``cap``. Past
    ``min(count, cap)`` the indices hold ``flat.numel()``, the values 0
    and ``live`` is False."""
    if flat.dim() != 1:
        raise ValueError(f"flat must be 1-D, got shape {tuple(flat.shape)}")
    with log.read():  # the count of nonzero words sizes the output
        nz = torch.nonzero(flat).flatten()
    count = int(nz.numel())
    k = min(cap, count)
    idx = torch.full((cap,), flat.numel(), dtype=torch.int64,
                     device=flat.device)
    idx[:k] = nz[:k]
    vals = torch.zeros(cap, dtype=flat.dtype, device=flat.device)
    vals[:k] = flat[nz[:k]]
    live = torch.arange(cap, device=flat.device) < count
    return count, idx, vals, live


def select_set_bits(
    flat: torch.Tensor, cap: int
) -> Tuple[int, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(count, word_index[cap], bit_index[cap], live[cap]) of the first
    ``cap`` set bits across the int32 words of the 1-D tensor ``flat``, in
    (word index, bit) order.

    ``count`` counts every set bit, also those past ``cap``. Past
    ``min(count, cap)`` the word indices hold ``flat.numel()``, the bit
    indices 0 and ``live`` is False (the JAX helper leaves arbitrary
    in-range values there, which its callers mask with ``live``)."""
    if flat.dim() != 1:
        raise ValueError(f"flat must be 1-D, got shape {tuple(flat.shape)}")
    dev = flat.device
    nz = torch.nonzero(flat).flatten()
    words = u32(flat[nz])
    pops = popcount32(words)
    count = int(pops.sum())
    k = min(cap, count)
    widx = torch.full((cap,), flat.numel(), dtype=torch.int64, device=dev)
    bit = torch.zeros(cap, dtype=torch.int64, device=dev)
    if k:
        # Only the words that hold the first k set bits are expanded.
        nw = int(torch.searchsorted(torch.cumsum(pops, 0),
                                    torch.tensor(k, device=dev))) + 1
        shifts = torch.arange(32, dtype=torch.int64, device=dev)
        bits = ((words[:nw, None] >> shifts) & 1).bool()
        row, col = torch.nonzero(bits, as_tuple=True)
        widx[:k] = nz[row[:k]]
        bit[:k] = col[:k]
    live = torch.arange(cap, device=dev) < count
    return count, widx, bit, live


def select_matches(ok: torch.Tensor, pid: torch.Tensor, end: torch.Tensor,
                   cap_m: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The first ``cap_m`` set slots of the 1-D flags ``ok`` as [cap_m]
    int64 (pid, end) gathered from the slot arrays beside it, -1 past the
    count (the verify stages' compaction, ``select_nonzero_words``)."""
    _, mi, _, mlive = select_nonzero_words(ok.to(torch.int32), cap_m)
    mi = mi.clamp(max=ok.numel() - 1)  # past the count mi is the size
    out_pid = torch.where(mlive, pid[mi].to(torch.int64), -1)
    out_end = torch.where(mlive, end[mi], -1)
    return out_pid, out_end
