"""Published peaks of the cards the benchmark knows, keyed by the name
``torch.cuda.get_device_name()`` gives.

NVIDIA's H100 SXM data sheet, dense rates at the full 700 W: 67 TFLOP/s in
float32 on the CUDA cores, 495 TFLOP/s in TF32 and 989 TFLOP/s in bfloat16
on the tensor cores, 3.35 TB/s of HBM3 (the float32 and HBM figures are
``pna_tpu_torch/ops/timing.py``'s).  A card that is not in the table has no
peak: the metrics that need one are then not reported.
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    'NVIDIA H100 80GB HBM3': dict(float32=67e12, tf32=495e12,
                                  bfloat16=989e12, hbm_bytes_per_s=3.35e12),
}


def peak(card: str) -> Optional[dict]:
    return PEAKS.get(card)
