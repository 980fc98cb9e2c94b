"""The yardstick's arithmetic: published peaks per card, the model FLOPs
and bytes of a pseudolikelihood value+gradient, and the least time the
card could take for them.

Copied from the port's bench_torch.py (DEVICE_PEAKS, plm_flops_per_seq_site)
so that a change to the program cannot move the yardstick; the augmented
width is worked out here, not imported.
"""

# Published dense peaks per card, keyed on torch.cuda.get_device_name():
# NVIDIA H100 SXM5 data sheet (the 700 W part), rates without sparsity.
# fp32_simt is the rate outside the tensor cores (IEEE SGEMM, "highest");
# bf16_tensor the tensor cores' bf16 rate (the limbs of "high"/"default").
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bf16_tensor": 989.4e12,
        "fp32_simt": 66.9e12,
        "hbm_bytes_per_s": 3.35e12,
    },
}


def device_peaks(kind):
    """The peak table of a card by its name (longest prefix), or None."""
    best = None
    for k in DEVICE_PEAKS:
        if kind.startswith(k) and (best is None or len(k) > len(best)):
            best = k
    return None if best is None else DEVICE_PEAKS[best]


def augmented_width(lq):
    """Width of the ones-augmented one-hot [onehot | 1 | 0...]: Lq + 1
    rounded up to a multiple of 128."""
    return ((lq + 1 + 127) // 128) * 128


def plm_flops_per_seq_site(l, q):
    """Model FLOPs per sequence-site of one value+gradient: the logits and
    dJh products against the augmented one-hot (2 x 2 Lq Lq_aug per row)
    and the per-site sums (4 Lq per row), divided by L. Elementwise work,
    the solver and any precision's extra passes are not counted."""
    lq = l * q
    return 4 * q * augmented_width(lq) + 4 * lq


def plm_bytes_per_evaluation(n, l, q):
    """Least bytes one value+gradient must move: the int8 codes and float32
    weights read once, the (Lq_aug, Lq) float32 parameters read once and
    the gradient of the same size written once."""
    lq = l * q
    return n * l + 4 * n + 2 * 4 * augmented_width(lq) * lq


def least_seconds(flops, nbytes, peak_flops, peaks):
    """The larger of the compute bound and the bandwidth bound."""
    return max(flops / peak_flops, nbytes / peaks["hbm_bytes_per_s"])
