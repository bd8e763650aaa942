"""Three-term roofline of the port on its card (port of
``repro.analysis.roofline``, whose constants are a TPU v5e's):

    compute term    = FLOPs per card / the card's dense bf16 rate
    memory term     = bytes per card / the card's HBM rate
    collective term = collective bytes per card / one NVLink direction

The FLOPs and bytes are :mod:`repro_torch.analysis.accounting`'s (every
limb product is one bf16 tensor-core product; each operand read once and
each output written once), so a share of the bound reads the same work
whatever implements it.  The constants are chosen by the card's name
(``torch.cuda.get_device_name()``); another name raises unless the caller
passes its constants.  ``parse_collectives`` (XLA HLO text) has no place
here: the collective bytes come from the counted collectives.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

H100_SXM = "NVIDIA H100 80GB HBM3"
H100_PCIE = "NVIDIA H100 PCIe"


@dataclasses.dataclass(frozen=True)
class Hardware:
    """Peak rates of one card."""

    name: str
    peak_bf16: float   # dense bf16 tensor-core ops/s
    hbm_bw: float      # device memory bytes/s
    peak_f32: float    # f32 ops/s outside the tensor cores
    link_bw: float     # NVLink bytes/s per direction


# NVIDIA's H100 datasheet (dense, without sparsity)
HARDWARE = {
    H100_SXM: Hardware(H100_SXM, peak_bf16=989e12, hbm_bw=3.35e12,
                       peak_f32=67e12, link_bw=450e9),
    H100_PCIE: Hardware(H100_PCIE, peak_bf16=756e12, hbm_bw=2.0e12,
                        peak_f32=51e12, link_bw=300e9),
}


def hardware(name: Optional[str] = None, *, peak_bf16: Optional[float] = None,
             hbm_bw: Optional[float] = None, peak_f32: Optional[float] = None,
             link_bw: Optional[float] = None) -> Hardware:
    """The constants of the card ``name`` (default: card 0's name).  A name
    not in :data:`HARDWARE` raises unless all four constants are given;
    given constants replace a known card's."""
    if name is None:
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("no card to name: pass the card's name")
        name = torch.cuda.get_device_name(0)
    given = dict(peak_bf16=peak_bf16, hbm_bw=hbm_bw, peak_f32=peak_f32,
                 link_bw=link_bw)
    given = {k: v for k, v in given.items() if v is not None}
    base = HARDWARE.get(name)
    if base is None:
        if len(given) != 4:
            raise ValueError(f"no roofline constants for {name!r}; have "
                             f"{sorted(HARDWARE)} (or pass all four)")
        return Hardware(name, **given)
    return dataclasses.replace(base, **given)


def bound_s(flops: float, nbytes: float, hw: Hardware,
            peak: Optional[float] = None):
    """(seconds, "operations" or "bytes"): the larger of the operations at
    ``peak`` (default the bf16 rate) and the bytes at the HBM rate."""
    t_ops = flops / (peak if peak is not None else hw.peak_bf16)
    t_bytes = nbytes / hw.hbm_bw
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


@dataclasses.dataclass
class Roofline:
    flops_per_chip: float
    bytes_per_chip: float
    collective_bytes_per_chip: float
    model_flops_global: float = 0.0
    n_chips: int = 1
    hw: Hardware = HARDWARE[H100_SXM]

    @property
    def compute_s(self) -> float:
        return self.flops_per_chip / self.hw.peak_bf16

    @property
    def memory_s(self) -> float:
        return self.bytes_per_chip / self.hw.hbm_bw

    @property
    def collective_s(self) -> float:
        return self.collective_bytes_per_chip / self.hw.link_bw

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        """Roofline step time = max of the three terms (perfect overlap)."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_flops_fraction(self) -> float:
        """MODEL_FLOPS / counted FLOPs (global): the limb products, remat's
        recompute and whatever else the model's 2N / 6N leaves out."""
        counted = self.flops_per_chip * self.n_chips
        return self.model_flops_global / counted if counted else 0.0

    @property
    def mfu_bound(self) -> float:
        """Model-FLOPs utilization at the roofline bound."""
        if self.bound_s <= 0:
            return 0.0
        achieved = self.model_flops_global / self.bound_s
        return achieved / (self.n_chips * self.hw.peak_bf16)

    def to_dict(self):
        return {
            "hardware": self.hw.name,
            "flops_per_chip": self.flops_per_chip,
            "bytes_per_chip": self.bytes_per_chip,
            "collective_bytes_per_chip": self.collective_bytes_per_chip,
            "compute_s": self.compute_s,
            "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "dominant": self.dominant,
            "bound_s": self.bound_s,
            "model_flops_global": self.model_flops_global,
            "useful_flops_fraction": self.useful_flops_fraction,
            "mfu_bound": self.mfu_bound,
            "n_chips": self.n_chips,
        }


def model_flops(cfg, phase: str, seq_len: int, global_batch: int) -> float:
    """MODEL_FLOPS = 6·N·D (train) or 2·N·D (fwd-only), N = active params."""
    n_active = cfg.active_param_count()
    tokens = seq_len * global_batch if phase != "decode" else global_batch
    mult = 6.0 if phase == "train" else 2.0
    return mult * n_active * tokens


def from_work(work, *, n_chips: int = 1, model_flops_global: float = 0.0,
              hw: Optional[Hardware] = None) -> Roofline:
    """The roofline of a counted :class:`~repro_torch.analysis.accounting.
    Work` (one card's share)."""
    return Roofline(flops_per_chip=float(work.flops),
                    bytes_per_chip=float(work.bytes),
                    collective_bytes_per_chip=float(work.coll_bytes),
                    model_flops_global=model_flops_global, n_chips=n_chips,
                    hw=hw or HARDWARE[H100_SXM])
