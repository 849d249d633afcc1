"""The ICP step's plain version (kernels/icp.py) and the loop that drives
it, on the CPU.

- ``icp_on_card`` with backend="torch" (``nn_plain`` and
  ``icp_step_plain`` in the card loop's chunks, the plain version of the
  card's ICP) reproduces ``icp``'s Python loop: the same iterations and
  flags, R and t within 1e-6 (float64 moments against the Python loop's
  float32 solve, on points near the origin);
- a step taken once done changes nothing;
- the chunk schedule of the card's loop, the chunks its plain branch
  launches, and result fields that are tensors of their own;
- CPU tensors and the Kabsch solver keep the plain loop: no step is
  launched and the span ``icp`` counts no ``launched``.
"""
import numpy as np
import pytest
import torch

from vtkcloudpoint_tpu_torch.config import ICPConfig
from vtkcloudpoint_tpu_torch.kernels import icp as k_icp
from vtkcloudpoint_tpu_torch.kernels.neighbor import nn_plain
from vtkcloudpoint_tpu_torch.register import icp as ti
from vtkcloudpoint_tpu_torch.utils import profiling as prof


def _rot(ang, axis=(0.0, 0.0, 1.0)):
    a = np.asarray(axis, np.float64)
    a /= np.linalg.norm(a)
    k = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + np.sin(ang) * k + (1 - np.cos(ang)) * k @ k


def _problem(seed, n=96):
    """Sources near the origin, their rigid image and the masks (every
    eleventh source invalid)."""
    rng = np.random.default_rng(seed)
    src = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    tgt = (src @ _rot(0.2).T + [0.1, -0.05, 0.02]).astype(np.float32)
    sv = np.ones(n, bool)
    sv[::11] = False
    return tuple(torch.from_numpy(a)
                 for a in (src, sv, tgt, np.ones(n, bool)))


def _step_loop(src, sv, tgt, tv, cfg):
    """icp_step_plain driven to max_iterations from icp's start pose; the
    steps past done are no-ops."""
    r, t = ti._start(src, sv, tgt, tv, cfg, None, None)
    state = k_icp.init_state(r, t, src)
    for _ in range(cfg.max_iterations):
        idx, d2 = nn_plain(state.p, tgt, tv)
        k_icp.icp_step_plain(state, idx, d2, src, sv, tgt, cfg.tol,
                             cfg.max_iterations)
    return state


@pytest.mark.parametrize("seed", [0, 5])
@pytest.mark.parametrize("cfg", [
    ICPConfig(max_iterations=30),
    ICPConfig(max_iterations=30, start_by_matching_centroids=False),
    ICPConfig(max_iterations=3),
    ICPConfig(max_iterations=30, tol=1e-10),
])
def test_plain_step_reproduces_the_plain_loop(seed, cfg):
    src, sv, tgt, tv = _problem(seed)
    ref = ti.icp(src, sv, tgt, tv, cfg)
    got = ti.icp_on_card(src, sv, tgt, tv, cfg, backend="torch")
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) == bool(ref.converged)
    for a, b in zip(got[:3], ref[:3]):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("n_valid", [0, 1])
def test_plain_step_with_one_or_no_valid_source(n_valid):
    """The plain loop's iterations and flags, and a final d of ~0: with no
    valid source R stays and the second step converges; one source lands
    on its nearest target."""
    src, sv, tgt, tv = _problem(1, n=12)
    sv = torch.zeros_like(sv)
    sv[:n_valid] = True
    cfg = ICPConfig(max_iterations=5)
    ref = ti.icp(src, sv, tgt, tv, cfg)
    got = ti.icp_on_card(src, sv, tgt, tv, cfg, backend="torch")
    assert int(got.iterations) == int(ref.iterations)
    assert bool(got.converged) and bool(ref.converged)
    assert float(got.error) == float(ref.error) <= 1e-12
    if not n_valid:
        assert int(ref.iterations) == 2
        assert torch.equal(got.r, torch.eye(3))


def test_plain_step_once_done_changes_nothing():
    src, sv, tgt, tv = _problem(2)
    state = _step_loop(src, sv, tgt, tv, ICPConfig(max_iterations=2))
    before = [x.clone() for x in state]
    idx, d2 = nn_plain(state.p, tgt, tv)
    k_icp.icp_step_plain(state, idx, d2, src, sv, tgt, 1e-4, 2)
    assert all(torch.equal(a, b) for a, b in zip(before, state))


@pytest.mark.parametrize("max_iterations,chunks", [
    (0, []), (1, [1]), (4, [4]), (5, [4, 1]), (12, [4, 8]),
    (13, [4, 8, 1]), (30, [4, 8, 8, 8, 2]), (50, [4] + [8] * 5 + [6]),
])
def test_chunk_schedule(max_iterations, chunks):
    assert k_icp.chunk_schedule(max_iterations) == chunks


@pytest.mark.parametrize("solver", ["horn", "kabsch"])
def test_cpu_tensors_keep_the_plain_loop(monkeypatch, solver):
    def refuse(*args, **kw):
        raise AssertionError("the card's loop ran on CPU tensors")

    monkeypatch.setattr(ti, "icp_on_card", refuse)
    k_icp.step_launches = 0
    src, sv, tgt, tv = _problem(3)
    with prof.recording() as rec:
        res = ti.icp(src, sv, tgt, tv, ICPConfig(max_iterations=30,
                                                  solver=solver))
    assert k_icp.step_launches == 0
    spans = [s for s in rec.spans if s.name == "icp"]
    assert len(spans) == 1 and "launched" not in spans[0].counters
    assert spans[0].counters["iterations"] == int(res.iterations) > 0


@pytest.mark.parametrize("tol,max_iterations", [(0.0, 13), (1e-4, 30)])
def test_card_loop_launches_whole_chunks(tol, max_iterations):
    """icp_on_card's plain branch: the span icp counts the iterations that
    ran and the chunks it launched, which stop at the first chunk that
    ends done; with tol 0 every iteration of max_iterations runs."""
    src, sv, tgt, tv = _problem(4)
    with prof.recording() as rec:
        res = ti.icp_on_card(src, sv, tgt, tv,
                             ICPConfig(max_iterations=max_iterations,
                                       tol=tol), backend="torch")
    (span,) = [s for s in rec.spans if s.name == "icp"]
    it, launched = span.counters["iterations"], span.counters["launched"]
    assert it == int(res.iterations) and launched >= it
    chunks = k_icp.chunk_schedule(max_iterations)
    ends = np.cumsum(chunks)
    assert launched == ends[np.searchsorted(ends, it)]
    assert bool(res.converged) == (tol > 0) and (it < max_iterations) == (
        tol > 0)


def test_card_loop_result_fields_are_their_own():
    """R, t and error of icp_on_card are tensors of their own, not views of
    the loop's state: each has its own storage, and writing one leaves the
    others as they were."""
    src, sv, tgt, tv = _problem(6)
    res = ti.icp_on_card(src, sv, tgt, tv, ICPConfig(max_iterations=5),
                         backend="torch")
    ptrs = {x.untyped_storage().data_ptr() for x in res[:3]}
    assert len(ptrs) == 3
    t, err = res.t.clone(), res.error.clone()
    res.r.fill_(7.0)
    assert torch.equal(res.t, t) and torch.equal(res.error, err)
