"""Published peaks of the cards the benchmark runs on.

NVIDIA H100 SXM data sheet, dense rates without sparsity, at its 700 W
limit: 989 TFLOP/s bf16, 495 TFLOP/s TF32, 67 TFLOP/s float32 outside the
tensor cores, 3.35 TB/s of HBM3.
"""

PEAKS = {
    "H100": {"bf16_flops": 989e12, "tf32_flops": 495e12,
             "fp32_flops": 67e12, "hbm_bytes_per_s": 3.35e12},
}


def peaks_for(device_name):
    """The peaks of the card named ``device_name``, or None when the table
    has no entry for it."""
    for key, peaks in PEAKS.items():
        if key in device_name:
            return peaks
    return None
