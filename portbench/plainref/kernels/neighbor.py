"""The plain nearest-neighbour search (``nn_plain``), copied from the port's
kernels/neighbor.py: squared distance from direct differences summed in
coordinate order, invalid references at BIG, ties to the lowest index."""
from __future__ import annotations

import torch

BIG = 1e30


def nn_plain(query, ref, ref_valid, chunk: int = 2048):
    """Nearest valid reference per query, query-tiled: (idx i32[N],
    d2 f32[N]); with no valid reference (0, BIG)."""
    idx, d2 = [], []
    for s in range(0, query.shape[0], max(chunk, 1)):
        q = query[s:s + chunk]
        e = q[:, None, 0] - ref[None, :, 0]
        d = e * e
        for k in range(1, q.shape[1]):
            e = q[:, None, k] - ref[None, :, k]
            d = d + e * e
        d = torch.where(ref_valid[None, :], d, BIG)
        i = torch.argmin(d, dim=1, keepdim=True)
        idx.append(i[:, 0].to(torch.int32))
        d2.append(torch.gather(d, 1, i)[:, 0])
    if not idx:
        return (torch.empty(0, dtype=torch.int32, device=query.device),
                torch.empty(0, dtype=query.dtype, device=query.device))
    return torch.cat(idx), torch.cat(d2)
