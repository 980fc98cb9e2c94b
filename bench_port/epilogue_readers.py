"""The reader of the bf16 block epilogue's route in the production fit.

On the card, each value+grad evaluation whose row blocks take K6 (the
program's kernels/block_epilogue.py, the Triton kernel
`_block_epilogue_kernel`: the block's softmax, per-site sums, NLL terms
and residual in one pass) records the count `epilogue_fused` on its
plm.value_grad span; an evaluation by the plain PyTorch chain records the
span without it. The reader returns None where its run holds nothing to
read: an untraced run, a control run, or a program that records no spans.
"""

from bench_port import program_spans


def epilogue_fused_share(ctx):
    """The share of the value+grad evaluations inside the counted fits'
    loops whose row blocks took K6 (plm.value_grad spans with the count
    `epilogue_fused`) (%)."""
    trees = program_spans.counted(ctx)
    if trees is None:
        return None
    evals = [r for t in trees for r in t.named("plm.value_grad",
                                               within="fit.loop")]
    if not evals:
        return None
    fused = sum(1 for r in evals if r["counts"].get("epilogue_fused"))
    return 100.0 * fused / len(evals)
