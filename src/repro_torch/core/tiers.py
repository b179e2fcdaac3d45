"""Execution tiers — Emerald's local/cloud split on one host and one card.

The paper assumes a weak "local computer" and a strong "cloud". Here a
tier is a named compute pool with a torch device and hardware constants
for the cost model: ``local`` is the host CPU, ``cloud`` is one NVIDIA
H100 on the same host. MDSS moves values between the two devices
(``Transport.transfer``), and a step offloaded to ``cloud`` runs on the
card.

Hardware constants:
  * cloud  — one H100 SXM (80 GB HBM3), NVIDIA's data-sheet peaks:
             989 TFLOP/s bf16 dense, 3.35 TB/s HBM. These rates assume the
             700 W power limit; the card this port was measured on reports
             "NVIDIA H100 80GB HBM3, 700.00 W" from
             ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``.
  * local  — a modeled workstation (the paper's "resource constrained"
             machine), and a modeled WAN/DCN link between the tiers. These
             are model inputs, not measurements of any device.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

H100_PEAK_BF16_FLOPS = 989e12
H100_HBM_BW = 3.35e12
DCN_BW = 1e9        # modeled local <-> cloud link (WAN-ish)
POD_DCI_BW = 25e9   # modeled cloud <-> cloud2 link


@dataclass
class Tier:
    name: str
    chips: int
    peak_flops_per_chip: float
    hbm_bw_per_chip: float
    device: Optional[torch.device] = None
    link_bw: Dict[str, float] = field(default_factory=dict)  # to other tiers
    link_latency_s: float = 1e-3

    @property
    def peak_flops(self) -> float:
        return self.chips * self.peak_flops_per_chip

    @property
    def hbm_bw(self) -> float:
        return self.chips * self.hbm_bw_per_chip

    def bw_to(self, other: str) -> float:
        return self.link_bw.get(other, DCN_BW)

    def synchronize(self):
        """Wait for the work queued on this tier's device (a no-op on the
        CPU): a step's completion is the end of its work, not of its
        launch."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def default_tiers(cloud_device=None) -> Dict[str, Tier]:
    """Host CPU as ``local``, one H100 as ``cloud`` (``cuda:0`` unless
    ``cloud_device`` names another device, e.g. ``"cpu"`` in tests).
    Raises when no card is present and the caller did not ask for one."""
    if cloud_device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "default_tiers: no CUDA device for the cloud tier; pass "
                "cloud_device='cpu' to run the cloud tier on the host")
        cloud_device = "cuda:0"
    dev = torch.device(cloud_device)
    tiers = {
        "local": Tier("local", chips=1, peak_flops_per_chip=2e12,
                      hbm_bw_per_chip=100e9, device=torch.device("cpu"),
                      link_bw={"cloud": DCN_BW, "cloud2": DCN_BW}),
        "cloud": Tier("cloud", chips=1,
                      peak_flops_per_chip=H100_PEAK_BF16_FLOPS,
                      hbm_bw_per_chip=H100_HBM_BW, device=dev,
                      link_bw={"local": DCN_BW, "cloud2": POD_DCI_BW}),
        # a second cloud tier stays declared, as in the reference; with one
        # card it runs on the same device as ``cloud``
        "cloud2": Tier("cloud2", chips=1,
                       peak_flops_per_chip=H100_PEAK_BF16_FLOPS,
                       hbm_bw_per_chip=H100_HBM_BW, device=dev,
                       link_bw={"local": DCN_BW, "cloud": POD_DCI_BW}),
    }
    return tiers
