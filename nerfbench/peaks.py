"""Published peaks of the cards the benchmark runs on, by the name
``torch.cuda.get_device_name()`` gives (NVIDIA's data sheet, SXM part, dense
rates without sparsity, at the full 700 W power limit)."""

PEAKS = {
    "NVIDIA H100 80GB HBM3": {"bf16_flops": 989e12, "hbm_bytes_per_s": 3.35e12},
}


def peak(kind: str, key: str):
    """The card's peak ``key``, or None for a card the table does not hold."""
    return PEAKS.get(kind, {}).get(key)
