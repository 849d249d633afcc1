"""Where the time of K1, the per-block DBSCAN kernel, goes on one GPU.

    python3 tools/profile_k1.py [--reps 20]

Builds a diagnostic library from the same source as the kernel library
(kernels/csrc/dbscan_block.cu) with the macro VTKCP_K1_PROFILE, under which
every block writes clock64() at its start and after each phase (and inside
the propagation, after the union-find's hook), and the number of propagation
sweeps (signed_sum_xy) or of column words whose core points span several
trees after the hook (the union-find), into an int64 [B, 8] buffer. The kernel library never has the macro. Runs that build on the
K1 blocks of the tier-2 job (489 blocks) and of the tier-3 job (4,883 blocks)
and prints for each, as JSON lines:

  phase_cycles   mean SM cycles per block in each phase, and their shares;
  phase_ms       the kernel library's CUDA-event time split by those shares;
  note           mean and largest sweep or mixed-word count per block;
  worst_blocks   the three slowest blocks, phase by phase;
  blocks_per_sm  resident blocks per SM by shared memory (1 or more);
and the kernel library's time beside the diagnostic build's (the cost of
the clocks). Phases: load (coordinates into shared memory), adjacency
(distances, bits and neighbour counts; the core flags), propagation (the
core graph's roots), rank (root ids), border (labels out). The labels of
the diagnostic build must equal the kernel library's.
"""
import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402

PHASES = ("load", "adjacency", "propagation", "rank", "border")
SLOTS = 8
SM_SMEM = 233472            # H100: shared memory per SM (228 KB)
BLOCK_RESERVED = 1024       # reserved by the runtime per resident block


def diagnostic_library():
    from vtkcloudpoint_tpu_torch.kernels import build

    sigs = {k: v for k, v in build.SIGNATURES.items()
            if k.startswith("vtkcp_dbscan")}
    sigs["vtkcp_k1_profile_buffer"] = (build._P,)
    path = build.build(("dbscan_block.cu",), ("VTKCP_K1_PROFILE",),
                       "libvtkcp_k1_profile")
    return build.open_library(path, sigs)


def blocks_of(inp):
    """The K1 input of a job: (coords [B, cap, 2], valid [B, cap])."""
    from vtkcloudpoint_tpu_torch.cluster.blocks import partition_gather_sorted

    T = inp.T
    bc, bv, _, _ = partition_gather_sorted(inp.motor, inp.valid,
                                           T["block_cap"], T["max_blocks"])
    return bc, bv


def split(name, bc, bv, T, lib, reps, card):
    import torch

    from vtkcloudpoint_tpu_torch.kernels import build
    from vtkcloudpoint_tpu_torch.kernels import dbscan as k_dbscan

    eps, min_pts, metric = T["eps"], T["min_pts"], T["metric"]
    B, cap, d = bc.shape
    prof = torch.zeros((B, SLOTS), dtype=torch.int64, device=bc.device)
    build.check(lib.vtkcp_k1_profile_buffer(prof.data_ptr()),
                "vtkcp_k1_profile_buffer")
    diag = k_dbscan.launch(bc, bv, eps, min_pts, metric, lib)
    prod = k_dbscan.dbscan_blocks_cuda(bc, bv, eps, min_pts, metric)
    torch.cuda.synchronize()
    for key in ("label", "n_clusters", "core"):
        chip_smoke.require(torch.equal(diag[key], prod[key]),
                           f"diagnostic K1 {key} differs ({name})")
    clocks = prof.cpu().numpy()
    cycles = (clocks[:, 1:len(PHASES) + 1]
              - clocks[:, :len(PHASES)]).astype(float)
    chip_smoke.require(bool((cycles >= 0).all()), "phase clocks not ordered")
    mean = cycles.mean(axis=0)
    share = mean / mean.sum()
    ms = chip_smoke.cuda_ms(lambda: k_dbscan.dbscan_blocks_cuda(
        bc, bv, eps, min_pts, metric), reps)
    diag_ms = chip_smoke.cuda_ms(lambda: k_dbscan.launch(
        bc, bv, eps, min_pts, metric, lib), reps)
    smem = lib.vtkcp_dbscan_smem_bytes(cap, d,
                                       k_dbscan.METRICS[metric])
    sweeps = clocks[:, SLOTS - 1]
    hooked = clocks[:, 6] != 0          # the union-find's mark after the hook
    hook = np.where(hooked, clocks[:, 6] - clocks[:, 2], 0).astype(float)
    worst = np.argsort(cycles.sum(axis=1))[::-1][:3]
    print(json.dumps({
        "k1_split": name, "card": card, "shape": f"B={B} cap={cap} D={d}",
        "ms": ms, "diagnostic_ms": diag_ms,
        "phase_cycles": dict(zip(PHASES, mean.tolist())),
        "phase_share": dict(zip(PHASES, share.round(4).tolist())),
        "phase_ms": dict(zip(PHASES, (share * ms).tolist())),
        "block_cycles_mean": float(cycles.sum(axis=1).mean()),
        "block_cycles_max": float(cycles.sum(axis=1).max()),
        "propagation_hook_cycles": float(hook.mean()),
        "propagation_union_cycles": float((cycles[:, 2] - hook).mean()),
        "note": "mixed words" if hooked.any() else "sweeps",
        "note_mean": float(sweeps.mean()), "note_max": int(sweeps.max()),
        "worst_blocks": [{
            "block": int(w), "phase_cycles": cycles[w].tolist(),
            "hook_cycles": float(hook[w]), "note": int(sweeps[w]),
            "valid": int(bv[w].sum()), "core": int(prod["core"][w].sum()),
            "clusters": int(prod["n_clusters"][w])} for w in worst],
        "smem_bytes": smem,
        "blocks_per_sm": SM_SMEM // (smem + BLOCK_RESERVED),
        "valid_per_block": float(bv.sum(dim=1).float().mean()),
        "core_per_block": float(prod["core"].sum(dim=1).float().mean()),
        "clusters_per_block": float(prod["n_clusters"].float().mean())}))


def main():
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_k1: no CUDA device", file=sys.stderr)
        return 1
    card = chip_smoke.card_name()
    print(card)
    dev = torch.device("cuda", 0)
    lib = diagnostic_library()
    for name, inputs in (("tier2", chip_smoke.tier2_inputs),
                         ("tier3", chip_smoke.tier3_inputs)):
        inp = inputs(dev)
        bc, bv = blocks_of(inp)
        split(name, bc, bv, inp.T, lib, args.reps, card)
        del inp, bc, bv
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
