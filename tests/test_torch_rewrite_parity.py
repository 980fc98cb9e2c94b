"""The randomized cases of tests/test_rewrite_parity.py with the port in
the reference's place: Pfam clan-overlap resolution and the
species-similarity selectors on the JAX file's seeded tables, and the
maxcluster and PSIPRED parsers on its inputs, each through both packages.
(The JAX file holds the JAX package to the original EVcouplings, which
this checkout does not carry; these cases need only the two packages.)

Tables are compared exactly: same rows, index, columns, dtypes and values.
"""

import numpy as np
import pandas as pd
import pytest

from evcouplings_tpu.align import pfam as jax_pfam
from evcouplings_tpu.complex import similarity as jax_similarity
from evcouplings_tpu.fold import tools as jax_tools
from evcouplings_torch.align import pfam
from evcouplings_torch.complex import similarity
from evcouplings_torch.fold import tools
from test_rewrite_parity import (
    TestMaxclusterParsers as _Maxcluster,
    TestPsipredParser as _Psipred,
    TestSimilaritySelectors as _Selectors,
)

# the JAX file's inputs (its classes are bound under private names, so
# this file does not collect them again)
COMPARISON, CLUSTERING = _Maxcluster.COMPARISON, _Maxcluster.CLUSTERING
VFORMAT, HFORMAT = _Psipred.VFORMAT, _Psipred.HFORMAT


def _clan_hits(seed):
    """test_rewrite_parity's randomized hmmscan hits (a small score
    alphabet forces ties)."""
    rng = np.random.default_rng(seed)
    n = int(rng.integers(5, 20))
    start = rng.integers(1, 70, size=n)
    return pd.DataFrame({
        "query_name": rng.choice(["q1", "q2"], size=n),
        "clan_id": rng.choice(["CL001", "CL002"], size=n),
        "ali_from": start,
        "ali_to": start + rng.integers(4, 35, size=n),
        "domain_score": rng.choice([10.0, 20.0, 20.0, 30.0], size=n),
    }, index=rng.permutation(n))


@pytest.mark.parametrize("seed", [1, 4, 8, 15, 23])
def test_clan_overlap_resolution(seed):
    pd.testing.assert_frame_equal(
        pfam.remove_clan_overlaps(_clan_hits(seed)),
        jax_pfam.remove_clan_overlaps(_clan_hits(seed)))


@pytest.mark.parametrize("seed", [2, 6, 9])
def test_most_similar_by_organism(seed):
    annotations, similarities = _Selectors._tables(seed)
    pd.testing.assert_frame_equal(
        similarity.most_similar_by_organism(similarities, annotations),
        jax_similarity.most_similar_by_organism(similarities, annotations))


@pytest.mark.parametrize("seed", [3, 12, 5])
@pytest.mark.parametrize("threshold", [0.7, 0.3])
def test_find_paralogs(seed, threshold):
    annotations, similarities = _Selectors._tables(seed)
    pd.testing.assert_frame_equal(
        similarity.find_paralogs("SEQ0_X/1-100", annotations, similarities,
                                 threshold),
        jax_similarity.find_paralogs("SEQ0_X/1-100", annotations,
                                     similarities, threshold))


def test_maxcluster_parsers():
    for parse in ("parse_maxcluster_comparison",
                  "parse_maxcluster_clustering"):
        for text in (COMPARISON, CLUSTERING):
            got = getattr(tools, parse)(text)
            pd.testing.assert_frame_equal(
                got, getattr(jax_tools, parse)(text))
    assert tools.parse_maxcluster_clustering(CLUSTERING).filename.tolist() \
        == ["model_1.pdb", "model_2.pdb", "model_3.pdb"]


@pytest.mark.parametrize("text", [VFORMAT, HFORMAT], ids=["v", "h"])
@pytest.mark.parametrize("first_index", [1, 7, 10])
def test_psipred_parser(tmp_path, text, first_index):
    path = tmp_path / "pred.ss2"
    path.write_text(text)
    pd.testing.assert_frame_equal(
        tools.read_psipred_prediction(str(path), first_index),
        jax_tools.read_psipred_prediction(str(path), first_index))
