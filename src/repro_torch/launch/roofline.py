"""The H100 roofline of the dry-run's cells, from spec-sheet constants.

Three terms per (arch x shape x mesh) cell, in seconds a step on one
device of the mesh:

    compute    = analytic FLOPs per device / PEAK_FLOPS[dtype]
    memory     = bytes each device must read (weights, cache) / HBM_BYTES_PER_S
    collective = per mesh axis, the bytes a device receives over that
                 axis's collectives / the axis's link rate (over
                 ``model``: the compute split's activation sums and the
                 gradients it leaves partial)

The FLOPs are the 6 N D convention (2 N D for prefill and decode), N the
active parameters (``N_active`` for MoE, the embedding counted half: a
lookup is traffic), as the reference's ``model_param_stats``.  The bytes
and collectives come from :mod:`repro_torch.launch.dryrun`.

Every constant below is a figure from NVIDIA's data sheet for the H100 SXM5
(dense rates, no sparsity, at the 700 W power limit) or of its DGX H100
node, not a measurement of this port.  A card set below 700 W runs slower.

    PYTHONPATH=src python -m repro_torch.launch.roofline [--multi-pod]
"""
from __future__ import annotations

import argparse
from typing import Dict, List

#: HBM3 bandwidth of one H100 SXM5, bytes/s (data sheet)
HBM_BYTES_PER_S = 3.35e12
#: device memory of one H100 SXM5, bytes (data sheet: 80 GB)
HBM_BYTES = 80e9
#: peak rates of one H100 SXM5, FLOP/s (data sheet, dense): bf16 on the
#: tensor cores, fp32 on the CUDA cores, tf32 on the tensor cores
PEAK_FLOPS = {"bfloat16": 989e12,
              "float32": 67e12,
              "tf32": 494.7e12}
#: NVLink 4 between the 8 GPUs of one node, bytes/s each way per GPU (data
#: sheet: 900 GB/s per GPU, both directions together)
NVLINK_BYTES_PER_S = 450e9
#: InfiniBand NDR between nodes, bytes/s each way per GPU (DGX H100: one
#: 400 Gb/s ConnectX-7 port a GPU)
IB_BYTES_PER_S = 50e9
#: GPUs of one NVLink node (DGX H100 / HGX H100 8-GPU)
GPUS_PER_NODE = 8


def axis_link_rate(mesh: Dict[str, int], axis: str) -> float:
    """Bytes/s each way per GPU over ``axis``: NVLink when the axis's ranks
    sit in one node (ranks are laid out row-major over the mesh axes, so
    an axis fits when its size times the sizes of the axes inside it is at
    most :data:`GPUS_PER_NODE`), InfiniBand otherwise."""
    names = list(mesh)
    span = 1
    for a in names[names.index(axis):]:
        span *= mesh[a]
    return NVLINK_BYTES_PER_S if span <= GPUS_PER_NODE else IB_BYTES_PER_S


def terms(cell: Dict) -> Dict:
    """The three terms of a dry-run cell (:func:`dryrun.run_cell`), the
    dominant one and the useful-compute bound's MFU."""
    t_compute = cell["flops_per_device"] / PEAK_FLOPS[cell["dtype"]]
    t_memory = cell["read_bytes_per_device"] / HBM_BYTES_PER_S
    t_coll = sum(b / axis_link_rate(cell["mesh"], a)
                 for a, b in cell["collective_bytes"].items())
    out = {"compute_s": t_compute, "memory_s": t_memory,
           "collective_s": t_coll}
    bound = max(out.values())
    out["dominant"] = max(out, key=out.get).replace("_s", "")
    out["bound_s"] = bound
    out["mfu_bound"] = t_compute / bound if bound else 0.0
    return out


def table(cells: List[Dict]) -> List[str]:
    rows = [f"{'arch':22s} {'shape':12s} {'mesh':8s} {'params GB':>9s} "
            f"{'opt GB':>7s} {'cache GB':>8s} {'fits':>4s} {'compute s':>10s} "
            f"{'memory s':>9s} {'coll. s':>9s} {'bound':>10s}"]
    for c in cells:
        if c.get("skipped"):
            rows.append(f"{c['arch']:22s} {c['shape']:12s} "
                        f"{c['mesh_name']:8s} skipped: {c['skipped']}")
            continue
        t = terms(c)
        rows.append(
            f"{c['arch']:22s} {c['shape']:12s} {c['mesh_name']:8s} "
            f"{c['param_bytes'] / 1e9:9.3f} {c['opt_bytes'] / 1e9:7.3f} "
            f"{c['cache_bytes'] / 1e9:8.3f} "
            f"{'yes' if c['resident_bytes'] <= HBM_BYTES else 'no':>4s} "
            f"{t['compute_s']:10.4f} {t['memory_s']:9.4f} "
            f"{t['collective_s']:9.4f} {t['dominant']:>10s}")
    return rows


def main(argv=None) -> int:
    from repro_torch.launch import dryrun
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi-pod", action="store_true")
    args = ap.parse_args(argv)
    print("H100 SXM5 spec-sheet constants (not measured): "
          f"{PEAK_FLOPS['bfloat16'] / 1e12:.0f} TFLOP/s bf16, "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s HBM3, NVLink "
          f"{NVLINK_BYTES_PER_S / 1e9:.0f} GB/s, InfiniBand "
          f"{IB_BYTES_PER_S / 1e9:.0f} GB/s per GPU each way")
    for row in table(dryrun.all_cells(multi_pod=args.multi_pod)):
        print(row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
