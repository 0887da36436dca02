"""Sparse compaction of kernel outputs (torch).

The port of `select_nonzero_words` from the JAX package's compaction
module. There it is a rank/select written in jnp because `jnp.nonzero`
lowers badly on a TPU; on the card and on the CPU `torch.nonzero` does
the same job directly. The JAX contract is kept: the first `cap` nonzero
words in index order, a `live` mask, and word indices filled with the
array size past the count (what the JAX bitap engine applies after the
call, `jnp.where(live, widx, size)`).
"""

from __future__ import annotations

from typing import Tuple

import torch


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
