"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheet, dense rates without sparsity, at the full power limit), by the
name torch.cuda.get_device_name() gives. A card missing here has no
roofline or mfu reading: its readers return nothing."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_ops_s": 989e12,
        "int8_ops_s": 1979e12,
        "f32_ops_s": 67e12,
        "hbm_bytes_s": 3.35e12,
    },
}


def peaks(device_kind: str):
    return PEAKS.get(device_kind)


def least_time(nbytes: float, ops: float, ops_s: float,
               bytes_s: float) -> float:
    """The least seconds a call needs: the larger of its bytes over the
    memory bandwidth and its operations over the compute peak."""
    return max(nbytes / bytes_s, ops / ops_s)
