"""Roofline chip-spec model: peak-rate floors for the step-time anatomy
(PyTorch port of ``deepspeed_tpu/utils/roofline.py``).

The roofline method (Williams et al., 2009) bounds a program's runtime from
below by each hardware resource it must saturate: executed flops can go no
faster than peak matrix throughput, touched bytes no faster than HBM
bandwidth, and collective bytes no faster than the link level they ride (the
``ici`` level within a node, ``dcn`` across nodes). ``utils/anatomy.py``
combines these floors with the measured overlap of collectives into a
predicted step floor and an MFU ceiling; this module owns the per-device
peak-rate table and the floor arithmetic, a copy of the JAX module's.

The table holds the H100 SXM's data-sheet figures (dense bf16 peak, HBM3
bandwidth, NVLink a direction as ``ici``, a 400 Gb/s NIC as ``dcn``) and the
``cpu-test`` bound for the CPU tests. The JAX table's TPU rows are a TPU's
numbers and are not carried. Every number is overridable through the
``telemetry.anatomy`` config block.
"""

from typing import Dict, Optional

__all__ = ["ChipSpec", "CHIP_SPECS", "detect_chip", "resolve_spec"]


class ChipSpec:
    """Peak rates of one chip generation. ``peak_tflops`` is dense bf16;
    bandwidths are GB/s (1e9 bytes per second) per chip."""

    __slots__ = ("name", "peak_tflops", "hbm_gbps", "ici_gbps", "dcn_gbps")

    def __init__(self, name: str, peak_tflops: float, hbm_gbps: float,
                 ici_gbps: float, dcn_gbps: float):
        self.name = name
        self.peak_tflops = float(peak_tflops)
        self.hbm_gbps = float(hbm_gbps)
        self.ici_gbps = float(ici_gbps)
        self.dcn_gbps = float(dcn_gbps)

    @property
    def peak_flops(self) -> float:
        return self.peak_tflops * 1e12

    def link_gbps(self, level: str) -> float:
        return self.dcn_gbps if level == "dcn" else self.ici_gbps

    def to_dict(self) -> Dict[str, float]:
        return {"name": self.name, "peak_tflops": self.peak_tflops,
                "hbm_gbps": self.hbm_gbps, "ici_gbps": self.ici_gbps,
                "dcn_gbps": self.dcn_gbps}

    def __repr__(self):
        return (f"ChipSpec({self.name!r}, peak_tflops={self.peak_tflops}, "
                f"hbm_gbps={self.hbm_gbps}, ici_gbps={self.ici_gbps}, "
                f"dcn_gbps={self.dcn_gbps})")


CHIP_SPECS = {
    # NVIDIA H100 SXM5 data-sheet figures, not measurements: 989 TFLOP/s
    # dense bf16 (tensor cores), 3350 GB/s HBM3, NVLink 4 (900 GB/s both
    # directions, 450 GB/s a direction) as the intra-node level, a 400 Gb/s
    # NIC (50 GB/s) as the inter-node level.
    "h100-sxm": ChipSpec("h100-sxm", 989.0, 3350.0, 450.0, 50.0),
    # CPU tests: rates a deliberate UPPER bound on any test machine, so
    # floor <= measured holds everywhere.
    "cpu-test": ChipSpec("cpu-test", 100.0, 1000.0, 100.0, 25.0),
}

# torch.cuda.get_device_name substrings -> spec table key
_KIND_PATTERNS = (("h100", "h100-sxm"),)


def detect_chip() -> str:
    """Spec-table key for the current CUDA device (``cpu-test`` for anything
    the table doesn't know, and where no card is in use)."""
    import torch
    if not torch.cuda.is_available():
        return "cpu-test"
    kind = torch.cuda.get_device_name().lower()
    for pattern, name in _KIND_PATTERNS:
        if pattern in kind:
            return name
    return "cpu-test"


def resolve_spec(chip: str = "", peak_tflops: float = 0.0,
                 hbm_gbps: float = 0.0, ici_gbps: float = 0.0,
                 dcn_gbps: float = 0.0) -> ChipSpec:
    """Spec for ``chip`` ("" = auto-detect) with per-field overrides (0 keeps
    the table value). Unknown chip names raise — a typo'd chip must not
    silently price the roofline off the CPU fallback."""
    name = chip or detect_chip()
    base = CHIP_SPECS.get(name)
    if base is None:
        raise ValueError(f"unknown chip {name!r}; known: "
                         f"{', '.join(sorted(CHIP_SPECS))}")
    return ChipSpec(base.name,
                    peak_tflops or base.peak_tflops,
                    hbm_gbps or base.hbm_gbps,
                    ici_gbps or base.ici_gbps,
                    dcn_gbps or base.dcn_gbps)


def compute_floor_seconds(flops: float, spec: ChipSpec) -> float:
    """Time the executed flops need at peak matrix throughput."""
    return max(float(flops), 0.0) / spec.peak_flops


def hbm_floor_seconds(hbm_bytes: float, spec: ChipSpec) -> float:
    """Time the touched bytes need at full HBM bandwidth."""
    return max(float(hbm_bytes), 0.0) / (spec.hbm_gbps * 1e9)


def comm_seconds(wire_bytes: float, level: str, spec: ChipSpec) -> float:
    """Time ``wire_bytes`` need on the ``level`` ("ici"/"dcn") link."""
    return max(float(wire_bytes), 0.0) / (spec.link_gbps(level) * 1e9)


def roofline(flops: float, hbm_bytes: float, exposed_ici_s: float,
             exposed_dcn_s: float, spec: ChipSpec,
             measured_seconds: Optional[float] = None) -> Dict[str, float]:
    """The roofline decomposition: per-resource floors, the predicted step
    floor (the binding compute/HBM floor plus all exposed communication —
    overlapped comm hides under compute by construction) and the MFU ceiling
    the program structure permits. With ``measured_seconds``, also attributes
    the measured wall time into compute / HBM-bound / exposed-ICI /
    exposed-DCN / host-gap residual."""
    compute_s = compute_floor_seconds(flops, spec)
    hbm_s = hbm_floor_seconds(hbm_bytes, spec)
    bound_s = max(compute_s, hbm_s)
    floor_s = bound_s + max(exposed_ici_s, 0.0) + max(exposed_dcn_s, 0.0)
    out = {
        "compute_floor_s": compute_s,
        "hbm_floor_s": hbm_s,
        "exposed_ici_s": max(exposed_ici_s, 0.0),
        "exposed_dcn_s": max(exposed_dcn_s, 0.0),
        "predicted_floor_s": floor_s,
        "mfu_ceiling": (compute_s / floor_s) if floor_s > 0 else 0.0,
    }
    if measured_seconds is not None:
        measured = max(float(measured_seconds), 0.0)
        out["measured_s"] = measured
        out["compute_s"] = compute_s
        out["hbm_bound_s"] = bound_s - compute_s
        out["host_gap_s"] = max(measured - floor_s, 0.0)
    return out
