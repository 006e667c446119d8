"""Three-term roofline of a kernel or a step on one NVIDIA H100.

Port of ``repro.launch.roofline``.  Target hardware is one H100 SXM
(NVIDIA's data sheet): 989 TFLOP/s dense bf16 on the tensor cores, 80 GB
of HBM3 at 3.35 TB/s, NVLink at 450 GB/s each way.  All inputs are
*per-device* quantities, so the three terms

    compute    = flops_per_device   / peak_flops
    memory     = bytes_per_device   / hbm_bw
    collective = coll_bytes_per_dev / ici_bw

are per-card seconds for one step or one kernel call.  The least time
under perfect overlap is the ``max`` of the three; the dominant term is
what bounds the work.  Count each input byte read once and each output
byte written once, and the operations the inputs at hand need.

``model_flops`` is the useful-math floor: 6·N·D for a train step
(fwd+bwd), 2·N·D for prefill, 2·N·B for one decode step (N = active
params, D = tokens).  ``useful_ratio = model_flops / counted FLOPs``
exposes redundant work; ``roofline_fraction = t_model / t_bound`` is the
fraction of the perfect-overlap bound spent on useful math.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class Hardware:
    name: str = "h100-sxm"
    peak_bf16: float = 989e12     # FLOP/s per card, dense bf16
    hbm_bw: float = 3.35e12       # B/s per card
    ici_bw: float = 450e9         # B/s per card over NVLink, one way


H100 = Hardware()


def roofline_terms(per_device: dict, hw: Hardware = H100) -> dict:
    """per_device: {flops, bytes, collective_bytes} -> 3 terms (seconds)."""
    t_comp = per_device["flops"] / hw.peak_bf16
    t_mem = per_device["bytes"] / hw.hbm_bw
    t_coll = per_device.get("collective_bytes", 0.0) / hw.ici_bw
    terms = {"compute_s": t_comp, "memory_s": t_mem, "collective_s": t_coll}
    dominant = max(terms, key=terms.get)
    bound = terms[dominant]
    return dict(terms, dominant=dominant.removesuffix("_s"),
                bound_s=bound)


def model_flops(kind: str, active_params: float, tokens: float) -> float:
    """Useful-math floor for the cell.

    kind: train (6·N·D: fwd 2 + bwd 4) | prefill (2·N·D) | decode (2·N·B,
    tokens = batch since one token decodes per sequence)."""
    mult = {"train": 6.0, "prefill": 2.0, "decode": 2.0}[kind]
    return mult * active_params * tokens


def analyze_cell(per_device: dict, kind: str, active_params: float,
                 tokens: float, n_devices: int, hw: Hardware = H100) -> dict:
    """Full roofline record for one (arch x shape x mesh) cell."""
    terms = roofline_terms(per_device, hw)
    mf_total = model_flops(kind, active_params, tokens)
    mf_dev = mf_total / n_devices
    hlo_flops = max(per_device["flops"], 1.0)
    t_model = mf_dev / hw.peak_bf16
    return dict(
        terms,
        model_flops_total=mf_total,
        model_flops_per_device=mf_dev,
        hlo_flops_per_device=per_device["flops"],
        useful_ratio=mf_dev / hlo_flops,
        roofline_fraction=t_model / max(terms["bound_s"], 1e-30),
    )


def format_row(name: str, rec: dict) -> str:
    return (f"{name:40s} comp={rec['compute_s']*1e3:9.3f}ms "
            f"mem={rec['memory_s']*1e3:9.3f}ms "
            f"coll={rec['collective_s']*1e3:9.3f}ms "
            f"dom={rec['dominant']:10s} "
            f"useful={rec['useful_ratio']:6.3f} "
            f"roofline={rec['roofline_fraction']*100:6.2f}%")
