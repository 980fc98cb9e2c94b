"""The port's EC post-processing (couplings/pairs.py, couplings/mapping.py)
against the JAX package's on the golden EC table and model.

Both sides run the same float64 numpy/scipy/pandas host code on the
same inputs, so every table here must agree to rtol 1e-12 (the
skew-normal EM, whose Nelder-Mead steps amplify any difference, is held
to the same bound: the inputs are identical, not merely close).
"""

import os

import numpy as np
import pandas as pd
import pytest

from evcouplings_tpu.couplings import mapping as jax_mapping
from evcouplings_tpu.couplings import pairs as jax_pairs
from evcouplings_torch.couplings import mapping, pairs
from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.utils.calculations import entropy_rows

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden")
EC_FILE = os.path.join(GOLDEN, "golden_ECs.txt")
MODEL_FILE = os.path.join(GOLDEN, "golden.model")
RTOL = 1e-12


def _frames_equal(got, want):
    pd.testing.assert_frame_equal(got.reset_index(drop=True),
                                  want.reset_index(drop=True),
                                  check_exact=False, rtol=RTOL, atol=0)


@pytest.fixture(scope="module")
def ecs():
    return pairs.read_raw_ec_file(EC_FILE)


@pytest.mark.parametrize("sort", [True, False])
@pytest.mark.parametrize("score", ["cn", "fn"])
def test_read_raw_ec_file_matches_jax(sort, score):
    got = pairs.read_raw_ec_file(EC_FILE, sort=sort, score=score)
    want = jax_pairs.read_raw_ec_file(EC_FILE, sort=sort, score=score)
    pd.testing.assert_frame_equal(got, want, check_exact=True)


@pytest.mark.parametrize("num_pairs,min_seqdist", [
    (1.0, 6), (0.5, 3), (20, 0),
])
def test_enrichment_matches_jax(ecs, num_pairs, min_seqdist):
    _frames_equal(
        pairs.enrichment(ecs, num_pairs=num_pairs, min_seqdist=min_seqdist),
        jax_pairs.enrichment(ecs, num_pairs=num_pairs,
                             min_seqdist=min_seqdist))


@pytest.mark.parametrize("model", ["skewnormal", "normal", "evcomplex"])
def test_add_mixture_probability_matches_jax(ecs, model):
    got = pairs.add_mixture_probability(ecs, model=model)
    want = jax_pairs.add_mixture_probability(ecs, model=model)
    _frames_equal(got, want)
    assert np.isfinite(got.probability).all()


def test_mixture_em_nan_guard_matches_jax():
    # a point mass plus extreme outliers collapses the skew-normal
    # scale; the EM stops at its last healthy iterate on both sides
    rng = np.random.default_rng(0)
    x = np.concatenate([rng.normal(0, 0.02, 2000), [5.0, 8.0, 1e4]])
    got = pairs.ScoreMixtureModel(x)
    want = jax_pairs.ScoreMixtureModel(x)
    assert np.all(np.isfinite(got.params))
    np.testing.assert_allclose(got.params, want.params, rtol=RTOL)
    probe = np.array([0.0, 0.05, 5.0, 1e4])
    p = got.probability(probe)
    assert np.all((0 <= p) & (p <= 1))
    np.testing.assert_allclose(p, want.probability(probe), rtol=RTOL)
    with pytest.raises(ValueError, match="positive score"):
        pairs.ScoreMixtureModel(np.array([-1.0, -2.0]))


def _golden_freqs():
    """Per-position frequency table in align's `_frequencies.csv`
    layout, from the golden model's f_i."""
    model = CouplingsModel(MODEL_FILE)
    table = pd.DataFrame(model.f_i, columns=list(model.alphabet))
    table.insert(0, "conservation", entropy_rows(model.f_i, normalize=True))
    table.insert(0, "A_i", list(model.target_seq))
    table.insert(0, "i", list(model.index_list))
    return model, table


@pytest.mark.parametrize("n_eff", [None, 1.0])
def test_logistic_regression_scorer_matches_jax(ecs, n_eff):
    model, freqs = _golden_freqs()
    n_eff = model.N_eff if n_eff is None else n_eff
    kw = dict(theta=0.8, effective_sequences=n_eff, num_sites=model.L)
    got = pairs.LogisticRegressionScorer().score(ecs, freqs, **kw)
    want = jax_pairs.LogisticRegressionScorer().score(ecs, freqs, **kw)
    _frames_equal(got, want)
    assert list(got.columns) == list(want.columns)


def test_scoring_model_file_is_the_jax_packages():
    with open(pairs.DEFAULT_LOGREG_MODEL_FILE) as a, \
            open(jax_pairs.DEFAULT_LOGREG_MODEL_FILE) as b:
        assert a.read() == b.read()


def _segments(module):
    return [module.Segment("aa", "A", 11, 20, range(11, 21)),
            module.Segment("aa", "B", 1, 8, range(1, 9), segment_id="B")]


@pytest.mark.parametrize("focus_mode", [True, False])
def test_segment_mapping_matches_jax(ecs, focus_mode):
    ours = mapping.SegmentIndexMapper(focus_mode, 11, *_segments(mapping))
    theirs = jax_mapping.SegmentIndexMapper(focus_mode, 11,
                                            *_segments(jax_mapping))
    assert ours.target_to_model == theirs.target_to_model
    assert ours.to_target([11, 25]) == theirs.to_target([11, 25])
    assert ours("B", 3) == theirs("B", 3)
    pd.testing.assert_frame_equal(mapping.segment_map_ecs(ecs, ours),
                                  jax_mapping.segment_map_ecs(ecs, theirs))
    seg = _segments(mapping)[1]
    assert mapping.Segment.from_list(seg.to_list()).to_list() == \
        seg.to_list()
    with pytest.raises(ValueError):
        mapping.Segment.from_list(seg.to_list()[:-1])


def test_multi_segment_model_matches_jax():
    ours = mapping.MultiSegmentCouplingsModel(MODEL_FILE,
                                              *_segments(mapping))
    theirs = jax_mapping.MultiSegmentCouplingsModel(
        MODEL_FILE, *_segments(jax_mapping))
    assert list(ours.index_list) == list(theirs.index_list)
    inter, inter_j = (ours.to_inter_segment_model(),
                      theirs.to_inter_segment_model())
    np.testing.assert_array_equal(inter.J_ij, inter_j.J_ij)
    np.testing.assert_array_equal(inter.h_i, inter_j.h_i)
    _frames_equal(ours.ecs, theirs.ecs.astype(ours.ecs.dtypes))
