"""The star catalog (paper section 10.2): a frozen copy of the port's
``repro_torch/data/synthetic.py::star_catalog_problem``.

17 base measurements, a 17 x 17 grid of products of two independent epochs
and a bias: 307 features. Base features are drawn around a node-dependent
shift, the configuration's ``node_shift`` (the port draws the shifts from
the seed, 0.5 N(0, 1) a node; a deployment states them); the label is a
noisy sparse logistic teacher; every column is divided by its standard
deviation over all rows (a column with none is left as it is). D is filled
in row blocks on the device from ``seed``; the few scalars and n-vectors
come from a CPU generator.
"""
from __future__ import annotations

import torch

BLOCK_ROWS = 1 << 18


def size(cfg: dict):
    """(rows, features) of the configuration's D."""
    nb = int(cfg["base_features"])
    return int(cfg["nodes"]) * int(cfg["rows_per_node"]), nb + nb * nb + 1


def make(cfg: dict, seed: int, device) -> dict:
    """{"D": (N, m_i, n), "labels": (N, m_i) in {-1, +1}}."""
    dev = torch.device(device)
    N, mi = int(cfg["nodes"]), int(cfg["rows_per_node"])
    nb = int(cfg["base_features"])
    dtype = getattr(torch, cfg["dtype"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed))
    small = torch.Generator()
    small.manual_seed(int(seed) + 1)
    n = nb + nb * nb + 1
    node_shift = [float(v) for v in cfg["node_shift"]]
    if len(node_shift) != N:
        raise ValueError(f"{N} nodes but {len(node_shift)} shifts")
    # the port's draw of the shifts, taken and set aside, so that the
    # teacher's weights below are the port's for the seed
    torch.randn(N, generator=small)
    w = torch.randn(n, generator=small) * (
        torch.rand(n, generator=small) < 0.1).to(torch.float32)
    D = torch.empty((N, mi, n), dtype=dtype, device=dev)
    s1 = torch.zeros(n, dtype=torch.float64, device=dev)
    s2 = torch.zeros(n, dtype=torch.float64, device=dev)
    for i in range(N):
        for s in range(0, mi, BLOCK_ROWS):
            e = min(mi, s + BLOCK_ROWS)
            b = e - s
            a = torch.randn((b, nb), generator=gen, dtype=dtype,
                            device=dev) + float(node_shift[i])
            a2 = torch.randn((b, nb), generator=gen, dtype=dtype,
                             device=dev) + float(node_shift[i])
            blk = D[i, s:e]
            blk[:, :nb] = a
            blk[:, nb:nb + nb * nb] = (a[:, :, None]
                                       * a2[:, None, :]).reshape(b, nb * nb)
            blk[:, -1] = 1.0
            s1 += blk.sum(0, dtype=torch.float64)
            s2 += (blk.double() ** 2).sum(0)
    total = N * mi
    var = torch.clamp(s2 / total - (s1 / total) ** 2, min=0.0)
    std = torch.sqrt(var)
    scale = torch.where(std > 1e-6, 1.0 / std, torch.ones_like(std)).to(dtype)
    w = w.to(device=dev, dtype=dtype)
    labels = torch.empty((N, mi), dtype=dtype, device=dev)
    for i in range(N):
        for s in range(0, mi, BLOCK_ROWS):
            e = min(mi, s + BLOCK_ROWS)
            blk = D[i, s:e]
            blk *= scale
            noise = 0.5 * torch.randn(e - s, generator=gen, dtype=dtype,
                                      device=dev)
            lab = torch.sign(blk @ w + noise)
            labels[i, s:e] = torch.where(lab == 0, torch.ones_like(lab), lab)
    return {"D": D, "labels": labels}
