"""Published peaks of the card (NVIDIA's H100 SXM data sheet, dense rates,
at its full 700 W power limit; ``device.power_limit`` in a result says the
card's own limit)."""

H100_SXM = {
    "fp32_flop_per_s": 67e12,   # float32 outside the tensor cores
    "tf32_flop_per_s": 495e12,
    "fp64_flop_per_s": 34e12,
    "hbm_bytes_per_s": 3.35e12,
}


def for_card(name: str):
    """The peaks of a card by its ``torch.cuda.get_device_name()``, or None
    for a card this table does not hold (a share of its peak is then not
    reported)."""
    return H100_SXM if "H100" in name else None
