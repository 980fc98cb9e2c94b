"""The port's plmc-compatibility helpers and logistic-regression
serialization (evcouplings_torch/couplings/tools.py, pairs.py) against the
JAX package's, through the cases of tests/test_couplings_tools.py that no
other port test holds: plmc logs of several shapes (and the ones it
refuses), the logistic-regression classifier's dict round trip, including
through a YAML file, and an sklearn-style object, and prepare_alignment's
focus numbering with a gapped focus row. (run_plmc's delegation is in
tests/test_torch_fitter.py.)

Dicts, statistics tuples, tables, numbering, strings and exception types
are compared exactly; decision values and probabilities within rtol 1e-15
(the same float64 numpy expression in both).
"""

import numpy as np
import pandas as pd
import pytest

from evcouplings_tpu.couplings import pairs as jax_pairs
from evcouplings_tpu.couplings.fitter import (
    prepare_alignment as jax_prepare_alignment,
)
from evcouplings_tpu.couplings.tools import parse_plmc_log as jax_parse
from evcouplings_torch.couplings import pairs
from evcouplings_torch.couplings.fitter import prepare_alignment
from evcouplings_torch.couplings.tools import parse_plmc_log
from evcouplings_torch.utils.config import (
    read_config_file, write_config_file,
)
from test_couplings_tools import PLMC_LOG

RTOL = 1e-15

LOGS = {
    "focus": PLMC_LOG,
    "non-focus": ("500 valid sequences out of 600\n"
                  "Effective number of samples: 123.4\n"
                  "Gradient optimization: Max iterations reached\n"),
    # iterations but no focus, region or site lines
    "iterations only": (
        "20 valid sequences out of 20\n"
        "Effective number of samples: 7.5\n"
        "iter          fx          -loglk    ||h||     ||e||    ||gh||    "
        "||ge||\n"
        "1     10.0      9.0    0.0    0.0    1.5    2.5\n"
        "Gradient optimization: Success\n"),
    # no optimization status line
    "no status": ("Found focus X as sequence 3\n"
                  "Region starts at 12\n"
                  "9 valid sequences out of 10\n"
                  "30 sites out of 31\n"
                  "Effective number of samples: 4.0\n"),
    "not a log": "not a plmc log at all",
    "empty": "",
}


def _outcome(fn, *args):
    try:
        return fn(*args)
    except Exception as e:   # the exception type is what is compared
        return type(e)


@pytest.mark.parametrize("name", list(LOGS))
def test_parse_plmc_log(name):
    got = _outcome(parse_plmc_log, LOGS[name])
    want = _outcome(jax_parse, LOGS[name])
    if isinstance(want, type):
        assert got is want
        return
    (df, stats), (jdf, jstats) = got, want
    assert stats == jstats
    if jdf is None:
        assert df is None
    else:
        pd.testing.assert_frame_equal(df, jdf)
    if name == "focus":
        assert stats == (1, 10430, 10884, 160, 166, 5, 2182.2, "Success")
        assert len(df) == 3


@pytest.mark.parametrize("feature_names", [["a", "b", "c"], None])
def test_logreg_round_trip(tmp_path, feature_names):
    """The same model serializes to the same dict in both packages, and
    each package restores the other's dict (also after a YAML file) to a
    classifier with the same decisions."""
    kw = dict(coef=[0.5, -1.2, 3.0], intercept=0.25)
    model = pairs.LinearLogisticModel(**kw)
    jax_model = jax_pairs.LinearLogisticModel(**kw)
    params = pairs.logreg_classifier_to_dict(model, feature_names)
    assert params == jax_pairs.logreg_classifier_to_dict(jax_model,
                                                        feature_names)
    assert params["model_settings"]["coef_"] == [[0.5, -1.2, 3.0]]

    path = str(tmp_path / "logreg.yml")
    write_config_file(path, params)
    X = np.random.default_rng(3).normal(size=(6, 3))
    for source in (params, read_config_file(path)):
        restored, names = pairs.logreg_classifier_from_dict(source)
        jax_restored, jax_names = jax_pairs.logreg_classifier_from_dict(
            source)
        assert names == jax_names == feature_names
        np.testing.assert_allclose(restored.decision_function(X),
                                   jax_restored.decision_function(X),
                                   rtol=RTOL, atol=0)
        np.testing.assert_allclose(restored.predict_proba_true(X),
                                   jax_restored.predict_proba_true(X),
                                   rtol=RTOL, atol=0)
        assert pairs.logreg_classifier_to_dict(restored, names) == params


class FakeSklearn:
    classes_ = np.array([0, 1])
    intercept_ = np.array([0.1])
    coef_ = np.array([[1.0, 2.0]])
    n_iter_ = np.array([7])

    def get_params(self):
        return {"C": 1.0, "penalty": "l2"}


def test_sklearn_style_object():
    params = pairs.logreg_classifier_to_dict(FakeSklearn(), ["x", "y"])
    assert params == jax_pairs.logreg_classifier_to_dict(FakeSklearn(),
                                                        ["x", "y"])
    assert params["classifier_settings"] == {"C": 1.0, "penalty": "l2"}
    restored, names = pairs.logreg_classifier_from_dict(params)
    assert names == ["x", "y"]
    np.testing.assert_allclose(restored.coef, [1.0, 2.0])
    assert restored.n_iter == [7]
    assert pairs.logreg_classifier_to_dict(restored, names) == \
        jax_pairs.logreg_classifier_to_dict(
            jax_pairs.logreg_classifier_from_dict(params)[0], names)


@pytest.mark.parametrize("kw", [
    dict(coef=[[1.0, 2.0], [3.0, 4.0]], intercept=[0.1, 0.2]),
    dict(coef=[1.0, 2.0], intercept=[0.1, 0.2]),
    dict(coef=[1.0, 2.0], intercept=0.1, classes=(0, 1, 2))])
def test_multi_class_models_are_refused(kw):
    assert _outcome(pairs.LinearLogisticModel, *kw.values()) is \
        _outcome(jax_pairs.LinearLogisticModel, *kw.values()) is ValueError


def test_gapped_focus_row_does_not_consume_numbering(tmp_path):
    """plmc's focus numbering advances along the focus sequence: gap
    columns of the focus row skip no number, lowercase inserts consume
    one, in both packages."""
    msa = tmp_path / "gapped.fasta"
    msa.write_text(">T/7-11\nAC-DeF\n>s1/1-6\nACWDEF\n>s2/1-6\nGC-DEW\n")
    got = prepare_alignment(str(msa), focus_seq="T/7-11")
    want = jax_prepare_alignment(str(msa), focus_seq="T/7-11")
    assert list(got["index_list"]) == list(want["index_list"]) == [
        7, 8, 9, 11]
    assert "".join(got["target_seq"]) == "".join(want["target_seq"]) == \
        "ACDF"
    np.testing.assert_array_equal(got["codes"], want["codes"])
    for key in ("num_valid_sites", "num_total_sites", "region_start",
                "focus_index", "num_valid_seqs"):
        assert got[key] == want[key], key
