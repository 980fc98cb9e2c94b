"""
Complex (EVcomplex) quickstart with the PyTorch port: two monomer
alignments -> per-species
best_hit pairing -> concatenated alignment -> Potts fit with segments
-> inter-chain EC ranking.

    python examples_torch/generate_data.py     # once
    python examples_torch/complex_quickstart.py

The demo alignments share species labels in their headers
("seqN_spM") and carry one planted inter-chain covarying pair:
chain A column 8 <-> chain B column 4 (1-based). The fit runs on the
CUDA device, or on the host with EVCOUPLINGS_TORCH_DEVICE=cpu.
"""

import os

import pandas as pd

HERE = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(HERE, "data")
OUT = os.path.join(HERE, "output", "complex")

# unset: the CUDA device; EVCOUPLINGS_TORCH_DEVICE=cpu: the host
DEVICE = os.environ.get("EVCOUPLINGS_TORCH_DEVICE") or None


def annotation_tables(a2m_path, out_prefix):
    """Build the annotation/identity tables the best_hit protocol
    expects (the align stage produces these in a pipeline run); here
    species are parsed from the demo headers 'seqN_spM'."""
    from evcouplings_torch.align.alignment import Alignment

    ali = Alignment.from_path(a2m_path)
    ids = list(ali.ids)

    species = []
    for id_ in ids:
        species.append(
            id_.split("_", 1)[1] if "_" in id_ else "Query"
        )

    anno_file = out_prefix + "_annotation.csv"
    pd.DataFrame({
        "id": ids, "name": ids, "OS": species,
    }).to_csv(anno_file, index=False)

    # identity of every row to the target (first row)
    target = ali.matrix[0]
    identity = (ali.matrix == target).mean(axis=1)
    id_file = out_prefix + "_identities.csv"
    pd.DataFrame({
        "id": ids, "identity_to_query": identity,
    }).to_csv(id_file, index=False)

    return anno_file, id_file


def main():
    os.makedirs(OUT, exist_ok=True)

    from evcouplings_torch.complex import protocol as complex_protocol
    from evcouplings_torch.couplings import protocol as couplings_protocol

    a1 = os.path.join(DATA, "demo_chain_a.a2m")
    a2 = os.path.join(DATA, "demo_chain_b.a2m")
    anno1, id1 = annotation_tables(a1, os.path.join(OUT, "chain_a"))
    anno2, id2 = annotation_tables(a2, os.path.join(OUT, "chain_b"))

    prefix = os.path.join(OUT, "demo")
    L1, L2 = 20, 16

    # --- 1. per-species best-hit concatenation ---
    concat = complex_protocol.run(
        protocol="best_hit",
        prefix=prefix,
        first_alignment_file=a1,
        second_alignment_file=a2,
        first_focus_sequence="DEMO_A/1-{}".format(L1),
        second_focus_sequence="DEMO_B/1-{}".format(L2),
        first_focus_mode=True, second_focus_mode=True,
        first_region_start=1, second_region_start=1,
        first_segments=[["aa", "A_1", "DEMO_A", 1, L1,
                         list(range(1, L1 + 1))]],
        second_segments=[["aa", "B_1", "DEMO_B", 1, L2,
                          list(range(1, L2 + 1))]],
        first_identities_file=id1, second_identities_file=id2,
        first_annotation_file=anno1, second_annotation_file=anno2,
        use_best_reciprocal=False,
        paralog_identity_threshold=0.95,
        # alignment post-processing (hhfilter only needed when
        # seqid_filter is set)
        hhfilter=None, seqid_filter=None, minimum_sequence_coverage=0,
        minimum_column_coverage=0, compute_num_effective_seqs=False,
        theta=0.8, device=DEVICE,
    )
    print("concatenated alignment:", concat["alignment_file"])
    print("paired sequences:", concat["num_sequences"])

    # --- 2. Potts fit over the concatenated alignment ---
    couplings = couplings_protocol.run(
        protocol="complex",
        prefix=prefix,
        alignment_file=concat["alignment_file"],
        focus_sequence=concat["focus_sequence"],
        segments=concat["segments"],
        focus_mode=True,
        theta=0.8, alphabet=None, ignore_gaps=False,
        iterations=60, lambda_h=0.01, lambda_J=0.01,
        lambda_group=None, lambda_J_times_Lq=True,
        scale_clusters=None, cpu=None, reuse_ecs=False,
        min_sequence_distance=3,
        scoring_model="skewnormal",
        use_all_ecs_for_scoring=False, device=DEVICE,
    )

    # --- 3. inter-chain ECs ---
    ecs = pd.read_csv(couplings["ec_file"])
    inter = ecs.query("segment_i != segment_j")
    print("top inter-chain ECs:")
    print(
        inter.head(5)[
            ["i", "A_i", "segment_i", "j", "A_j", "segment_j", "cn"]
        ].to_string(index=False)
    )
    top = inter.iloc[0]
    assert (int(top.i), int(top.j)) == (8, 4), \
        "planted inter pair (8, 4) should rank first"
    print("planted inter-chain pair (A:8 <-> B:4) recovered as top hit")


if __name__ == "__main__":
    main()
