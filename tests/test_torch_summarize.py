"""The port's run summarizer (evcouplings_torch.utils.summarize) against
the JAX package's: protein_monomer and protein_complex over the same
seeded sub-job trees write byte-equal summary tables, the port draws the
monomer figure where matplotlib is present, and without matplotlib its
monomer summarizer raises ImportError naming it before writing anything.
"""

import os
import sys

import numpy as np
import pandas as pd
import pytest

from evcouplings_torch.utils import summarize
from evcouplings_torch.utils.config import write_config_file


def _write_monomer_subjob(root, name, rng, threshold, L=30, complete=True):
    """One finished monomer sub-job: its run config and final outcfg, the
    statistics, identities, frequencies, EC and compared-EC files."""
    prefix = os.path.join(root, name)
    stats = pd.DataFrame({
        "prefix": [prefix], "num_seqs": [int(rng.integers(100, 1000))],
        "seqlen": [L + 5], "num_cov": [L],
        "N_eff": [float(rng.uniform(50, 500))],
    })
    stats.to_csv(prefix + "_alignment_statistics.csv", index=False)
    pd.DataFrame({"id": ["s{}".format(k) for k in range(40)],
                  "identity_to_query": rng.uniform(0.1, 1.0, 40)}).to_csv(
        prefix + "_identities.csv", index=False)
    pd.DataFrame({"i": np.arange(1, L + 1),
                  "-": rng.uniform(0, 0.5, L)}).to_csv(
        prefix + "_frequencies.csv", index=False)
    i, j = np.triu_indices(L, 1)
    order = rng.permutation(len(i))
    pd.DataFrame({"i": i[order] + 1, "j": j[order] + 1,
                  "probability": rng.uniform(0, 1, len(i))}).to_csv(
        prefix + "_CouplingScores.csv", index=False)
    pd.DataFrame({"i": i[order][:2 * L] + 1, "j": j[order][:2 * L] + 1,
                  "precision": np.sort(rng.uniform(0, 1, 2 * L))[::-1]}
                 ).to_csv(prefix + "_CouplingScoresCompared_longrange.csv",
                          index=False)
    cfg = {"global": {"prefix": prefix},
           "align": {"domain_threshold": threshold,
                     "minimum_column_coverage": 70},
           "couplings": {"min_sequence_distance": 6}}
    cfg_file = prefix + "_config.txt"
    write_config_file(cfg_file, cfg)
    if complete:
        write_config_file(prefix + "_final.outcfg", {
            "statistics_file": prefix + "_alignment_statistics.csv",
            "effective_sequences": float(stats.N_eff[0]) - 0.5,
            "identities_file": prefix + "_identities.csv",
            "frequencies_file": prefix + "_frequencies.csv",
            "ec_file": prefix + "_CouplingScores.csv",
            "ec_compared_longrange_file":
                prefix + "_CouplingScoresCompared_longrange.csv"})
    return cfg_file


def _write_complex_subjob(root, name, rng, L=(20, 15)):
    """One finished complex sub-job: statistics of both monomers and the
    concatenation, the EC table and compared ECs with segments."""
    prefix = os.path.join(root, name)
    pd.DataFrame({"prefix": [prefix], "num_seqs": [500], "seqlen": [sum(L)],
                  "num_cov": [sum(L)], "N_eff": [float(rng.uniform(50, 300))]}
                 ).to_csv(prefix + "_alignment_statistics.csv", index=False)
    for tag, n in (("first", L[0]), ("second", L[1])):
        pd.DataFrame({"num_cov": [n]}).to_csv(
            prefix + "_{}_statistics.csv".format(tag), index=False)
    pd.DataFrame({"num_seqs_1": [700], "num_seqs_2": [650],
                  "median_num_per_species_1": [1.5],
                  "median_num_per_species_2": [2.0]}).to_csv(
        prefix + "_concatenation_statistics.csv", index=False)
    n = sum(L)
    i, j = np.triu_indices(n, 1)
    seg = np.where(np.arange(n) < L[0], "A_1", "B_1")
    order = rng.permutation(len(i))
    ecs = pd.DataFrame({"i": i[order] + 1, "j": j[order] + 1,
                        "segment_i": seg[i[order]], "segment_j": seg[j[order]],
                        "probability": rng.uniform(0, 1, len(i))})
    ecs.to_csv(prefix + "_CouplingScores.csv", index=False)
    ecs.assign(segmentwise_precision=rng.uniform(0, 1, len(ecs))).to_csv(
        prefix + "_CouplingScoresCompared_longrange.csv", index=False)
    write_config_file(prefix + "_config.txt",
                      {"global": {"prefix": prefix},
                       "compare": {"min_sequence_distance": 4}})
    write_config_file(prefix + "_final.outcfg", {
        "statistics_file": prefix + "_alignment_statistics.csv",
        "effective_sequences": None,
        "ec_file": prefix + "_CouplingScores.csv",
        "ec_compared_longrange_file":
            prefix + "_CouplingScoresCompared_longrange.csv",
        "first_statistics_file": prefix + "_first_statistics.csv",
        "second_statistics_file": prefix + "_second_statistics.csv",
        "concatentation_statistics_file":
            prefix + "_concatenation_statistics.csv"})
    return prefix + "_config.txt"


@pytest.fixture
def monomer_tree(tmp_path):
    rng = np.random.default_rng(11)
    root = str(tmp_path / "jobs")
    os.makedirs(root)
    # three finished sub-jobs of a bitscore sweep and one still running
    configs = [_write_monomer_subjob(root, "job_b{}".format(t), rng, t)
               for t in (0.7, 0.3, 0.5)]
    configs.append(_write_monomer_subjob(root, "job_b0.9", rng, 0.9,
                                         complete=False))
    return tmp_path, configs


def _summary_bytes(module, prefix, pipeline, configs):
    module.PIPELINE_TO_SUMMARIZER[pipeline](prefix, configs)
    with open(prefix + "_job_statistics_summary.csv", "rb") as f:
        return f.read()


def test_monomer_summary_matches_jax(monomer_tree):
    from evcouplings_tpu.utils import summarize as jax_summarize

    tmp_path, configs = monomer_tree
    got = _summary_bytes(summarize, str(tmp_path / "torch"),
                         "protein_monomer", configs)
    want = _summary_bytes(jax_summarize, str(tmp_path / "jax"),
                          "protein_monomer", configs)
    assert got == want
    table = pd.read_csv(tmp_path / "torch_job_statistics_summary.csv")
    assert list(table.domain_threshold) == [0.3, 0.5, 0.7]
    assert {"num_significant", "precision", "average_identity"} <= set(
        table.columns)
    assert os.path.getsize(tmp_path / "torch_job_statistics_summary.pdf") > 0


def test_complex_summary_matches_jax(tmp_path):
    from evcouplings_tpu.utils import summarize as jax_summarize

    rng = np.random.default_rng(12)
    root = str(tmp_path / "jobs")
    os.makedirs(root)
    configs = [_write_complex_subjob(root, "cpx_{}".format(k), rng)
               for k in range(2)]
    got = _summary_bytes(summarize, str(tmp_path / "torch"),
                         "protein_complex", configs)
    want = _summary_bytes(jax_summarize, str(tmp_path / "jax"),
                          "protein_complex", configs)
    assert got == want
    table = pd.read_csv(tmp_path / "torch_job_statistics_summary.csv")
    assert len(table) == 2
    assert {"first_n_seqs", "top_inter_rank", "inter_precision",
            "first_monomer_precision"} <= set(table.columns)


def test_monomer_summary_without_matplotlib(monomer_tree, monkeypatch):
    tmp_path, configs = monomer_tree
    before = sorted(os.listdir(tmp_path))
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        summarize.protein_monomer(str(tmp_path / "torch"), configs)
    assert sorted(os.listdir(tmp_path)) == before
    # the complex summarizer draws nothing and still runs
    summarize.protein_complex(str(tmp_path / "cpx"), [])
    assert os.path.isfile(tmp_path / "cpx_job_statistics_summary.csv")


def test_summarize_command(monomer_tree):
    from click.testing import CliRunner

    from evcouplings_torch.utils.config import InvalidParameterError

    tmp_path, configs = monomer_tree
    prefix = str(tmp_path / "cli")
    result = CliRunner().invoke(summarize.app,
                                ["protein_monomer", prefix] + configs)
    assert result.exit_code == 0, result.output
    assert len(pd.read_csv(prefix + "_job_statistics_summary.csv")) == 3
    result = CliRunner().invoke(summarize.app, ["protein_dimer", prefix])
    assert isinstance(result.exception, InvalidParameterError)
