"""
Tutorial: alignment handling and analysis with the Alignment class of
the PyTorch port (evcouplings_torch).

Executable counterpart of the reference's
notebooks/alignment_analysis.ipynb — the same walkthrough against the
bundled demo alignment: I/O, row/column selection, statistics
(frequencies, conservation, identities), and the notebook's exercises
(most-gapped sequence, all-vs-all identity matrix, sampling a random
alignment from the per-column frequency profile).

    python examples_torch/generate_data.py              # once
    python examples_torch/tutorial_alignment_analysis.py [output_dir]
"""

import os
import sys

import matplotlib

matplotlib.use("Agg")

import matplotlib.pyplot as plt
import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")

# where the numeric work runs: unset is the CUDA device (raises without
# one), EVCOUPLINGS_TORCH_DEVICE=cpu the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None


def section(title):
    print("\n" + "=" * 8, title, "=" * 8)


def main(out=None):
    out = out or os.path.join(HERE, "output", "tutorial_alignment")
    os.makedirs(out, exist_ok=True)

    from evcouplings_torch.align import Alignment, map_matrix

    # ------------------------------------------------------------
    section("1. Alignment input and output")
    with open(os.path.join(DATA, "demo_monomer.a2m")) as f:
        aln = Alignment.from_file(f, format="fasta", device=DEVICE)
    print("alignment is of length {} and has {} sequences".format(
        aln.L, aln.N))

    # write it back out (fasta here; a2m/stockholm work the same way)
    with open(os.path.join(out, "roundtrip.fasta"), "w") as f:
        aln.write(f, format="fasta")

    # alignments can also be built from a dict of id -> sequence
    aln2 = Alignment.from_dict({"seq1": "HELLO", "seq2": "WORLD"},
                               device=DEVICE)
    print("from_dict alignment: {} x {}".format(aln2.N, aln2.L))

    # ------------------------------------------------------------
    section("2. Selecting rows and columns")
    # aln.matrix is the (N, L) character matrix
    print("sequence 10, positions 1-10:",
          "".join(aln.matrix[9, 0:10]))

    # look rows up by identifier
    some_id = aln.ids[3]
    index = aln.id_to_index[some_id]
    print("sequence {} has index {}".format(some_id, index))
    print("the sequence is", "".join(aln[some_id]))

    # subset rows / columns into a new Alignment
    picks = [aln.id_to_index[x] for x in aln.ids[5:8]]
    sub = aln.select(sequences=picks)
    print("row selection: {} sequences".format(sub.N))
    sub = aln.select(columns=range(0, 15))
    print("column selection: {} positions".format(sub.L))

    # ------------------------------------------------------------
    section("3. Alignment statistics")
    # integer-coded matrix (the form the port's device code consumes)
    mapped = map_matrix(aln.matrix, aln.alphabet_map)
    print("mapped matrix dtype/shape:", mapped.dtype, mapped.shape)

    col = 3  # position 4, one of the planted covarying columns
    freqs = aln.frequencies[col]
    top = np.argsort(freqs)[::-1][:3]
    print("top symbols at position {}:".format(col + 1), [
        "{}={:.2f}".format(aln.alphabet[i], freqs[i]) for i in top
    ])
    cons = aln.conservation()[col]
    print("position {} conservation (normalized entropy): {:.2f}".format(
        col + 1, cons))

    idents = aln.identities_to(aln.matrix[0])
    print("mean identity to target: {:.2f}".format(idents.mean()))

    # ------------------------------------------------------------
    section("4. Exercises")
    # which sequence contains the most gaps?
    most_gapped = aln.count(axis="seq", char="-").argmax()
    assert most_gapped == (aln.matrix == "-").sum(axis=1).argmax()
    print("most gapped sequence:", aln.ids[most_gapped])

    # all-vs-all identity heatmap
    identity_matrix = np.stack([
        aln.identities_to(aln.matrix[k]) for k in range(aln.N)
    ])
    plt.figure(figsize=(5, 4))
    plt.imshow(identity_matrix, cmap="Blues", vmin=0, vmax=1)
    plt.colorbar(label="fraction identity")
    png = os.path.join(out, "identity_heatmap.png")
    plt.savefig(png, dpi=120)
    print("wrote", png)

    # sample a random alignment from the per-column frequency profile
    rng = np.random.default_rng(0)
    n_seqs = 2000
    sampled = np.empty((n_seqs, aln.L), dtype="U1")
    for i in range(aln.L):
        sampled[:, i] = rng.choice(
            list(aln.alphabet), size=n_seqs, p=aln.frequencies[i]
        )
    rand_aln = Alignment.from_dict({
        "rand_{}".format(k): "".join(row) for k, row in enumerate(sampled)
    }, device=DEVICE)
    drift = np.abs(rand_aln.frequencies - aln.frequencies).max()
    print("highest frequency drift of the sampled alignment: "
          "{:.3f}".format(drift))

    print("\ntutorial outputs in", out)
    return aln, identity_matrix


if __name__ == "__main__":
    main(sys.argv[1] if len(sys.argv) > 1 else None)
