"""Plain PyTorch SSV sweep: the reference form of the CUDA sweep kernel.

The counterpart of `havac_tpu/ops/ssv_xla.py` `ssv_scan_xla`: the DP
dependency is diagonal-only, so each model row updates as one vectorised
step over all L sequence positions. Unlike the XLA scan it emits hit keys
instead of dense strip bitmaps, with the same contract as the kernel
(`havac_tpu_torch/ops/ssv_cuda.py`):

    key = ((row + row_offset) << 38) | (position + pos_offset)

It runs on any device. The CPU tests hold it against the JAX package, and
the chip smoke test holds the CUDA kernel against it on the card; the engine
uses it only for CPU tensors.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

KEY_POS_BITS = 38
MAX_ROW = 1 << 25  # rows must fit the key's upper 25 bits
MAX_POS = 1 << KEY_POS_BITS


def ssv_sweep_plain(
    symbols: torch.Tensor,
    scores: torch.Tensor,
    init_state: torch.Tensor,
    init_carry: torch.Tensor,
    reset_rows: Optional[torch.Tensor] = None,
    row_offset: int = 0,
    pos_offset: int = 0,
    dump: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Sweep (P rows x L positions); returns (keys, final_state, final_carry).

    ``symbols`` uint8 (L,) codes < card; ``scores`` int8 (P, card), raw
    (unbiased); ``init_state`` int32 (L,) = S[-1][*]; ``init_carry`` int32
    (P+1,), entry j = S[j-1][-1]; ``reset_rows`` optional int32 (P,), nonzero
    where the incoming diagonal state is forced to 0 (model isolation).

    ``keys`` int64 (n,) hold every hit, sorted by (row, position);
    ``final_state`` int32 (L,) = S[P-1][*]; ``final_carry`` int32 (P+1,) with
    final_carry[0] = init_state[L-1] and final_carry[j+1] = S[j][L-1].

    ``dump``, when given, is a (P, L) uint8 tensor that receives every
    post-update state, row j = S[j][*] (all lie in [0, 255]): the plain
    version of the kernel's row-dump variant.
    """
    L = symbols.shape[0]
    P = scores.shape[0]
    sym = symbols.long()
    table = scores.to(torch.int32)
    carry_in = init_carry.to(torch.int32)
    reset = None if reset_rows is None else reset_rows.tolist()
    row = init_state.to(torch.int32)
    carry = torch.empty(P + 1, dtype=torch.int32, device=row.device)
    carry[0] = row[L - 1]
    parts = []
    zero = torch.zeros((), dtype=torch.int32, device=row.device)
    for j in range(P):
        if reset is not None and reset[j]:
            shifted = torch.zeros_like(row)
        else:
            shifted = torch.cat([carry_in[j:j + 1], row[:-1]])
        s = shifted + table[j].index_select(0, sym)
        hit = s >= 256
        row = torch.where((s < 0) | hit, zero, s)
        if dump is not None:
            dump[j].copy_(row)
        carry[j + 1] = row[L - 1]
        cols = torch.nonzero(hit).flatten()
        if cols.numel():
            parts.append(((j + row_offset) << KEY_POS_BITS)
                         | (cols + pos_offset))
    keys = (torch.cat(parts) if parts
            else torch.empty(0, dtype=torch.int64, device=row.device))
    return keys, row, carry
