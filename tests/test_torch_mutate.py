"""The port's mutation-effect calculations (evcouplings_torch/mutate)
against the JAX package's, through the cases of tests/test_mutate.py:
extract_mutations (offsets, wild-type spellings, strings it cannot parse),
predict_mutation_table (the model's deltas, the Hamiltonian's components,
NaN for mutations it cannot score, the index as the mutant source, a
wild-type row with segments), the layout and values of
single_mutant_matrix with and without self-substitutions, split_mutants,
and the mutate stage's plots with a broken bokeh.

Both packages read the same seeded plmc_v2 `.model` file (test_model's
make_model, written once by the JAX package) and get the same tables.
Strings, integers, tables' columns and index, and NaN positions are
compared exactly; Delta-E and the float columns within rtol 1e-12 (both
compute in float64 numpy on the host).
"""

import sys
import types

import numpy as np
import pandas as pd
import pytest

from evcouplings_tpu.couplings.mapping import (
    Segment as JaxSegment, SegmentIndexMapper as JaxSegmentIndexMapper,
)
from evcouplings_tpu.couplings.model import CouplingsModel as JaxModel
from evcouplings_tpu.mutate import calculations as jax_calc
from evcouplings_tpu.mutate import protocol as jax_protocol
from evcouplings_torch.couplings.mapping import Segment, SegmentIndexMapper
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.mutate import calculations as calc
from evcouplings_torch.mutate import protocol
from test_model import make_model

RTOL = 1e-12


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    """(port model, JAX model) read from one seeded .model file
    (positions 5..12)."""
    path = str(tmp_path_factory.mktemp("mutate") / "seeded.model")
    make_model().to_file(path, precision="float32", file_format="plmc_v2")
    return CouplingsModel(path, device="cpu"), JaxModel(path)


def _outcome(fn, *args, **kwargs):
    """fn's result, or the type of the exception it raised."""
    try:
        return fn(*args, **kwargs)
    except Exception as e:   # the exception type is what is compared
        return type(e)


def assert_same_table(got, want):
    pd.testing.assert_frame_equal(got, want, check_exact=False, rtol=RTOL,
                                  atol=0)


@pytest.mark.parametrize("string,offset", [
    ("K50R", 0), ("K50R,I100V", 2), ("K50R,I100V", -3), ("wt", 0),
    ("WT", 0), ("wild", 0), ("Wild", 0), ("", 0), ("K50fs", 0),
    ("50R", 0), ("K50R;I100V", 0)])
def test_extract_mutations(string, offset):
    got = _outcome(calc.extract_mutations, string, offset=offset)
    assert got == _outcome(jax_calc.extract_mutations, string,
                           offset=offset)
    if string == "K50R,I100V" and offset == 2:
        assert got == [(52, "K", "R"), (102, "I", "V")]


def test_extract_mutations_separator():
    assert calc.extract_mutations("K50R;I100V", sep=";") == \
        jax_calc.extract_mutations("K50R;I100V", sep=";") == \
        [(50, "K", "R"), (100, "I", "V")]


def test_predict_matches_model_deltas(models):
    port, jax = models
    wt = {pos: port.seq(pos) for pos in port.index_list}
    table = pd.DataFrame({"mutant": [
        "{}5A".format(wt[5]), "{}7C,{}10W".format(wt[7], wt[10]), "wt"]})
    got = calc.predict_mutation_table(port, table)
    assert_same_table(got, jax_calc.predict_mutation_table(jax, table))
    assert got.prediction_epistatic.iloc[0] == pytest.approx(
        port.delta_hamiltonian([(5, wt[5], "A")])[0], rel=RTOL)
    assert got.prediction_epistatic.iloc[2] == 0.0


@pytest.mark.parametrize("hamiltonian", ["full", "couplings", "fields",
                                         "bogus"])
def test_predict_components(models, hamiltonian):
    port, jax = models
    table = pd.DataFrame({"mutant": ["{}5A".format(port.seq(5)),
                                     "{}6C".format(port.seq(6))]})
    got = _outcome(calc.predict_mutation_table, port, table,
                   hamiltonian=hamiltonian, output_column="x")
    want = _outcome(jax_calc.predict_mutation_table, jax, table,
                    hamiltonian=hamiltonian, output_column="x")
    if hamiltonian == "bogus":
        assert got is want is ValueError
    else:
        assert_same_table(got, want)


def test_full_is_couplings_plus_fields(models):
    port, _ = models
    table = pd.DataFrame({"mutant": ["{}5A".format(port.seq(5))]})
    full, coup, fields = (
        calc.predict_mutation_table(port, table, hamiltonian=h)
        .prediction_epistatic.iloc[0]
        for h in ("full", "couplings", "fields"))
    assert full == pytest.approx(coup + fields, rel=RTOL)


def test_invalid_mutations_get_nan(models):
    port, jax = models
    table = pd.DataFrame({"mutant": [
        "A999C",                                  # not in the model
        "{}5J".format(port.seq(5)),               # J not in the alphabet
        "{}5A,A999C".format(port.seq(5)),         # one of two unscorable
        "{}5A".format(port.seq(5))]})
    got = calc.predict_mutation_table(port, table)
    assert_same_table(got, jax_calc.predict_mutation_table(jax, table))
    assert list(got.prediction_epistatic.isna()) == [True, True, True,
                                                     False]


def test_index_as_mutant_source(models):
    port, jax = models
    table = pd.DataFrame({"x": [1.0, 2.0]}, index=[
        "{}5A".format(port.seq(5)), "{}8W".format(port.seq(8))])
    got = calc.predict_mutation_table(port, table, mutant_column=None)
    assert_same_table(got, jax_calc.predict_mutation_table(
        jax, table, mutant_column=None))


def _segmented(model, segment_cls, mapper_cls):
    seg = segment_cls("aa", "TGT", 1, model.L, list(model.index_list))
    seg.segment_id = "A_1"
    mapper_cls(True, int(model.index_list[0]), seg).patch_model(model)
    return model


def test_predict_wildtype_row_with_segments(tmp_path):
    """A filled segment column: the wild-type rows score 0, the others the
    segment-keyed Delta-E, the same in both packages."""
    path = str(tmp_path / "seg.model")
    make_model().to_file(path, precision="float32", file_format="plmc_v2")
    port = _segmented(CouplingsModel(path, device="cpu"), Segment,
                      SegmentIndexMapper)
    jax = _segmented(JaxModel(path), JaxSegment, JaxSegmentIndexMapper)
    seg_id, pos = port.index_list[0]
    assert (seg_id, pos) == tuple(jax.index_list[0])
    aa_from = port.seq((seg_id, pos))
    aa_to = next(a for a in port.alphabet if a not in (aa_from, "-"))
    table = pd.DataFrame({
        "mutant": ["wt", "{}{}{}".format(aa_from, pos, aa_to), ""],
        "segment": [seg_id, seg_id, seg_id]})
    got = calc.predict_mutation_table(port, table, mutant_column="mutant")
    assert_same_table(got, jax_calc.predict_mutation_table(
        jax, table, mutant_column="mutant"))
    assert got.prediction_epistatic.iloc[0] == 0.0
    assert np.isfinite(got.prediction_epistatic.iloc[1])


@pytest.mark.parametrize("exclude_self_subs", [True, False])
def test_single_mutant_matrix(models, exclude_self_subs):
    port, jax = models
    got = calc.single_mutant_matrix(port, exclude_self_subs=exclude_self_subs)
    assert_same_table(got, jax_calc.single_mutant_matrix(
        jax, exclude_self_subs=exclude_self_subs))
    assert len(got) == 8 * (19 if exclude_self_subs else 20)
    assert list(got.columns) == [
        "segment", "mutant", "pos", "wt", "subs", "frequency",
        "column_conservation", "prediction_epistatic"]
    assert not (got.subs == "-").any()
    self_rows = got[got.wt == got.subs]
    assert len(self_rows) == (0 if exclude_self_subs else 8)
    assert (self_rows.prediction_epistatic == 0).all()


@pytest.mark.parametrize("mutants", [
    ["K50R", "I100V,K120R"], ["A10V", "K50fs", "A10V,K12R"],
    ["wt", "A10V"]])
def test_split_mutants(mutants):
    x = pd.DataFrame({"mutant": mutants, "y": np.arange(len(mutants))})
    got = _outcome(calc.split_mutants, x, "mutant")
    want = _outcome(jax_calc.split_mutants, x, "mutant")
    if isinstance(want, type):
        assert got is want
        return
    pd.testing.assert_frame_equal(got, want)
    if mutants[0] == "K50R":
        assert list(got.num_mutations) == [1, 2]
        assert list(got.pos) == ["50", "100,120"]
        assert list(got.wt) == ["K", "I,K"]
        assert list(got.subs) == ["R", "V,R"]


def test_plot_models_degrades_on_broken_bokeh(tmp_path, monkeypatch,
                                              models):
    """A bokeh that imports but lacks its plotting surface: both packages'
    mutate plots write only the static PDF, under the same name."""
    import matplotlib
    matplotlib.use("Agg")

    for name in ("bokeh", "bokeh.io", "bokeh.plotting", "bokeh.models"):
        monkeypatch.setitem(sys.modules, name, types.ModuleType(name))
    sys.modules["bokeh.io"].output_file = lambda *a, **k: None
    sys.modules["bokeh.io"].save = lambda *a, **k: None

    port, jax = models
    files = {}
    for tag, module, c, model in (("torch", protocol, calc, port),
                                  ("jax", jax_protocol, jax_calc, jax)):
        outcfg = {"mutation_matrix_plot_files": []}
        prefix = str(tmp_path / tag / "mut")
        (tmp_path / tag).mkdir()
        module._plot_models([(c.single_mutant_matrix(model), "Epistatic")],
                            prefix, outcfg)
        files[tag] = [f[len(prefix):]
                      for f in outcfg["mutation_matrix_plot_files"]]
    assert files["torch"] == files["jax"] == ["_epistatic_model.pdf"]
