"""PyTorch port vs the JAX package: DBSCAN (plain path on the CPU).

Labels, core flags and cluster counts must be bit-equal. L2 fixtures keep
every pair away from the eps boundary: the reference's dense path decides
sqrt(expansion) <= eps while its Pallas kernel decides sum(diff^2) <= eps^2.
"""
import numpy as np
import jax.numpy as jnp
import pytest
import torch
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import connected_components

from vtkcloudpoint_tpu.cluster import dbscan as jd
from vtkcloudpoint_tpu.ops.pallas.dbscan_kernel import dbscan_blocks_pallas
from vtkcloudpoint_tpu.ops.pallas.neighbor import nn_pallas
from vtkcloudpoint_tpu_torch.cluster import dbscan as td
from vtkcloudpoint_tpu_torch.kernels import neighbor as k_nn

from tests.conftest import make_blobs

KEYS = ("label", "n_clusters", "core")


def _blocks(seed, B=4, cap=128, dims=2, n_clusters=3, pts_per=25, noise=15,
            spread=0.012):
    rng = np.random.default_rng(seed)
    coords = np.zeros((B, cap, dims), np.float32)
    valid = np.zeros((B, cap), bool)
    for b in range(B):
        pts = make_blobs(rng, n_clusters=n_clusters, pts_per=pts_per,
                         noise=noise, spread=spread)
        if dims == 3:
            pts = np.concatenate([pts, spread * rng.standard_normal(
                (len(pts), 1))], axis=1)
        coords[b, :len(pts)] = pts
        valid[b, :len(pts)] = True
    return coords, valid


def _margin(coords, valid, eps):
    """Least |d - eps| over valid pairs, d the exact Euclidean distance."""
    worst = np.inf
    for c, v in zip(coords.astype(np.float64), valid):
        p = c[v]
        d = np.sqrt(((p[:, None] - p[None]) ** 2).sum(-1))
        worst = min(worst, np.abs(d - eps).min())
    return worst


def _eq(a, b):
    for key in KEYS:
        np.testing.assert_array_equal(np.asarray(a[key]), b[key].numpy(),
                                      err_msg=key)


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy"])
def test_dbscan_blocks_matches_jax(seed, metric):
    coords, valid = _blocks(seed)
    a = jd.dbscan_blocks(jnp.asarray(coords), jnp.asarray(valid), 0.06, 9,
                         metric)
    b = td.dbscan_blocks(torch.from_numpy(coords), torch.from_numpy(valid),
                         0.06, 9, metric, chunk=3)
    _eq(a, b)


@pytest.mark.parametrize("dims", [2, 3])
def test_dbscan_blocks_l2_matches_jax(dims):
    coords, valid = _blocks(10 + dims, B=2, dims=dims, n_clusters=2,
                            pts_per=30, noise=10, spread=0.01)
    eps = 0.05
    assert _margin(coords, valid, eps) > 1e-5
    a = jd.dbscan_blocks(jnp.asarray(coords), jnp.asarray(valid), eps, 6,
                         "l2_xyz")
    b = td.dbscan_blocks(torch.from_numpy(coords), torch.from_numpy(valid),
                         eps, 6, "l2_xyz")
    _eq(a, b)


def test_dbscan_blocks_matches_pallas_kernel():
    coords, valid = _blocks(21)
    a = dbscan_blocks_pallas(jnp.asarray(coords), jnp.asarray(valid), 0.06,
                             9)
    b = td.dbscan_blocks(torch.from_numpy(coords), torch.from_numpy(valid),
                         0.06, 9)
    _eq(a, b)


def test_dispatch_on_cpu_is_plain():
    coords, valid = _blocks(5, B=3)
    c, v = torch.from_numpy(coords), torch.from_numpy(valid)
    a = td.dbscan_blocks(c, v, 0.06, 9)
    for backend in ("auto", "torch"):
        b = td.dbscan_blocks_dispatch(c, v, 0.06, 9, backend=backend)
        for key in KEYS:
            assert torch.equal(a[key], b[key])


@pytest.mark.parametrize("cf", [0, 7])
@pytest.mark.parametrize("max_iters", [1, 64])
def test_dbscan_padded_cf_and_max_iters(cf, max_iters):
    rng = np.random.default_rng(30)
    pts = make_blobs(rng, n_clusters=5, pts_per=30, noise=40,
                     spread=0.015).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[::13] = False
    a = jd.dbscan_padded(jnp.asarray(pts), jnp.asarray(valid), 0.05, 5,
                         cf=cf, max_iters=max_iters)
    b = td.dbscan_padded(torch.from_numpy(pts), torch.from_numpy(valid),
                         0.05, 5, cf=torch.tensor(cf, dtype=torch.int32),
                         max_iters=max_iters)
    _eq(a, b)


@pytest.mark.parametrize("chunk", [32, 2048])
@pytest.mark.parametrize("metric", ["l1_motor", "signed_sum_xy"])
def test_dbscan_dense_chunked(chunk, metric):
    rng = np.random.default_rng(31)
    pts = make_blobs(rng, n_clusters=4, pts_per=30, noise=50,
                     spread=0.015).astype(np.float32)
    valid = np.ones(len(pts), bool)
    valid[5::17] = False
    a = jd.dbscan_dense_chunked(jnp.asarray(pts), jnp.asarray(valid), 0.05,
                                5, metric, cf=3, chunk=chunk)
    b = td.dbscan_dense_chunked(torch.from_numpy(pts),
                                torch.from_numpy(valid), 0.05, 5, metric,
                                cf=3, chunk=chunk)
    c = td.dbscan_padded(torch.from_numpy(pts), torch.from_numpy(valid),
                         0.05, 5, metric, cf=3)
    _eq(a, b)
    for key in KEYS:
        assert torch.equal(b[key], c[key])


def test_dbscan_matlab_convention():
    rng = np.random.default_rng(32)
    pts = make_blobs(rng, n_clusters=3, pts_per=20, noise=20,
                     spread=0.01).astype(np.float32)
    assert _margin(pts[None], np.ones((1, len(pts)), bool), 0.04) > 1e-5
    la, na = jd.dbscan_matlab_convention(pts, 5, 0.04)
    lb, nb = td.dbscan_matlab_convention(torch.from_numpy(pts), 5, 0.04)
    np.testing.assert_array_equal(np.asarray(la), lb.numpy())
    assert int(na) == int(nb)
    assert (lb.numpy() == -1).any() and (lb.numpy() > 0).any()


# ---- the invariants the Hopper kernels rest on (K1 union-find, K3 merge) --


def _kernel_adjacency(coords, valid, eps, metric):
    """K1's decision d(i, j) <= thr from direct differences in coordinate
    order (the Pallas kernel's): L1, signed sum, or squared L2 against
    eps^2 squared in double and rounded once. [n, n] bool, valid pairs."""
    c = torch.from_numpy(coords)
    e = c[:, None, :] - c[None, :, :]
    if metric == "l1_motor":
        terms, thr = e.abs(), np.float32(eps)
    elif metric == "signed_sum_xy":
        terms, thr = e, np.float32(eps)
    else:
        terms, thr = e * e, np.float32(eps * eps)
    d = terms[..., 0]
    for k in range(1, c.shape[1]):
        d = d + terms[..., k]
    v = torch.from_numpy(valid)
    return (d <= float(thr)) & v[:, None] & v[None, :]


def _roots(adj, valid, min_pts):
    """The plain fixpoint of dbscan_blocks over this adjacency: (core,
    root), root the least index reachable over core edges (n if not
    core)."""
    core = (adj.sum(dim=1) >= min_pts) & torch.from_numpy(valid)
    core_adj = adj & core[:, None] & core[None, :]
    return core, td._min_label_fixpoint(core_adj, core, adj.shape[0])


def _component_minima(adj, core):
    """Least index of each connected component of the core graph (scipy),
    taken for each core point; n for the others."""
    n = adj.shape[0]
    core_adj = (adj & core[:, None] & core[None, :]).numpy()
    _, comp = connected_components(csr_matrix(core_adj), directed=False)
    least = np.full(comp.max() + 1, n)
    np.minimum.at(least, comp, np.arange(n))
    return np.where(core.numpy(), least[comp], n)


@pytest.mark.parametrize("metric,dims", [("l1_motor", 2), ("l2_xyz", 2),
                                         ("l2_xyz", 3)])
def test_symmetric_metrics_fixpoint_is_component_minimum(metric, dims):
    """For l1_motor and l2, K1's adjacency is bitwise symmetric, and the
    plain min-label fixpoint is the least index of each connected component
    of the core graph: what K1's union-find computes."""
    coords, valid = _blocks(40 + dims, B=1, cap=256, dims=dims,
                            n_clusters=4, pts_per=50, noise=40,
                            spread=0.02)
    coords, valid = coords[0], valid[0]
    adj = _kernel_adjacency(coords, valid, 0.03, metric)
    assert torch.equal(adj, adj.T)
    core, root = _roots(adj, valid, 6)
    assert int(core.sum()) > 100
    np.testing.assert_array_equal(root.numpy(), _component_minima(adj, core))
    if metric == "l1_motor":       # the plain path's own adjacency
        plain = td._adjacency(torch.from_numpy(coords),
                              torch.from_numpy(valid), 0.03, metric)
        assert torch.equal(plain, adj)


def test_signed_sum_adjacency_is_directed():
    """signed_sum_xy: d(j, i) = -d(i, j), so the adjacency is not
    symmetric and the plain fixpoint (directed reachability) differs from
    the connected-component minimum a union-find would give. K1 keeps the
    propagation sweeps for this metric."""
    rng = np.random.default_rng(50)
    coords = rng.uniform(0, 1, (128, 2)).astype(np.float32)
    valid = np.ones(128, bool)
    valid[::9] = False
    adj = _kernel_adjacency(coords, valid, 0.05, "signed_sum_xy")
    assert not torch.equal(adj, adj.T)
    core, root = _roots(adj, valid, 8)
    comp = _component_minima(adj, core)
    differ = root.numpy() != comp
    assert bool(differ.any())
    # the plain path decides the same pairs, and labels by the fixpoint
    plain = td._adjacency(torch.from_numpy(coords), torch.from_numpy(valid),
                          0.05, "signed_sum_xy")
    assert torch.equal(plain, adj)
    first = int(np.flatnonzero(differ)[0])
    assert int(root[first]) > comp[first]


# K3's merge key (float bits of d2) << 32 | idx of (BIG, index 0): the
# answer with no valid reference
EMPTY_KEY = int(np.float32(k_nn.BIG).view(np.uint32)) << 32


def _nn_split_merge(query, ref, ref_valid, splits, split_len):
    """K3's merge rule on the CPU: the plain argmin of each reference
    split, packed as (float bits of d2) << 32 | index into int64 keys that
    start at (BIG, 0), and the least key per query."""
    keys = torch.full((query.shape[0],), EMPTY_KEY, dtype=torch.int64)
    for s in range(splits):
        lo, hi = s * split_len, min(ref.shape[0], (s + 1) * split_len)
        idx, d2 = k_nn.nn_plain(query, ref[lo:hi], ref_valid[lo:hi])
        bits = d2.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
        key = (bits << 32) | (idx.to(torch.int64) + lo)
        keys = torch.where(d2 < k_nn.BIG, torch.minimum(keys, key), keys)
    return ((keys & 0xFFFFFFFF).to(torch.int32),
            (keys >> 32).to(torch.int32).view(torch.float32))


@pytest.mark.parametrize("n", [300, 1024])
def test_nn_split_merge_ties_equal_plain_and_pallas(n):
    """Exact distance ties across K3's split boundaries: every reference
    repeated 3 times, the copies in different splits, the first copies
    partly invalid. The least key (d2 bits, then index) is nn_plain's
    answer bit for bit, and JAX's nn_pallas's (interpret mode) index for
    index."""
    rng = np.random.default_rng(n)
    base = rng.uniform(0, 1, (700, 3)).astype(np.float32)
    ref = np.concatenate([base, base, base])
    valid = rng.random(len(ref)) < 0.8
    valid[:40] = False
    query = (base[rng.integers(0, 700, n)]
             + np.float32(0.125)).astype(np.float32)
    q, r, v = (torch.from_numpy(a) for a in (query, ref, valid))
    # the grid K3 takes on an H100 (132 SMs)
    splits, split_len = k_nn.nn_splits(n, len(ref), 256,
                                       k_nn.NN_BLOCKS_PER_SM * 132)
    assert splits > 3 and split_len < len(base)
    got = _nn_split_merge(q, r, v, splits, split_len)
    plain = k_nn.nn_plain(q, r, v)
    assert torch.equal(got[0], plain[0]) and torch.equal(got[1], plain[1])
    ji, jd2 = nn_pallas(jnp.asarray(query), jnp.asarray(ref),
                        jnp.asarray(valid))
    np.testing.assert_array_equal(np.asarray(ji), plain[0].numpy())
    # d2 within 2 ulp: XLA:CPU may contract the interpreted kernel's
    # multiply-adds, which the port (and K3, --fmad=false) never does
    np.testing.assert_allclose(np.asarray(jd2, np.float32), plain[1].numpy(),
                               rtol=2.5e-7, atol=0)
    # with no valid reference: (0, BIG)
    idx, d2 = _nn_split_merge(q, r, torch.zeros_like(v), splits, split_len)
    assert bool((idx == 0).all()) and bool((d2 == np.float32(k_nn.BIG)).all())
