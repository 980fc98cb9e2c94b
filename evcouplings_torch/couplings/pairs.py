"""
Evolutionary-coupling pair tables: I/O, enrichment, significance models,
and logistic-regression rescoring (port of
evcouplings_tpu/couplings/pairs.py; the parity notes below name the
upstream EVcouplings reference).

This is small-data host post-processing (tables of at most L*(L-1)/2
rows), so it stays in numpy/scipy/pandas. The logistic-regression
rescorer is a plain linear model evaluated natively (sigmoid of X @ w +
b) and reads the reference's serialized YAML model schema; the port
ships its own copy of the scoring model in scoring_models/.
"""

from copy import deepcopy
from math import ceil
from pathlib import Path

import numpy as np
import pandas as pd
import scipy.optimize as op
from scipy import stats

from evcouplings_torch.utils.calculations import median_absolute_deviation
from evcouplings_torch.utils.config import read_config_file

# scoring model shipped with the package (same weights as the reference's
# scoring_models/logistic_regression_all.yml, trained on large run sets)
SCORING_MODELS_DIR = Path(__file__).parent / "scoring_models"
DEFAULT_LOGREG_MODEL_FILE = str(
    SCORING_MODELS_DIR / "logistic_regression_all.yml"
)


def read_raw_ec_file(filename, sort=True, score="cn"):
    """Read a raw EC file (plmc format: `i A_i j A_j fn cn`, space-sep).

    Parity: reference pairs.py:34-65.
    """
    ecs = pd.read_csv(
        filename, sep=" ", names=["i", "A_i", "j", "A_j", "fn", "cn"]
    )
    if sort:
        # stable sort keeps plmc's file order within tied scores, so
        # round-tripping a reference-produced EC file is deterministic
        ecs = ecs.sort_values(by=score, ascending=False, kind="stable")
    return ecs


def enrichment(ecs, num_pairs=1.0, score="cn", min_seqdist=6):
    """Per-position EC "enrichment" (Hopf et al., Cell, 2012).

    Sums the top-EC coupling strength incident to each position and
    normalizes by the average strength of the selected top pairs.
    Parity: reference pairs.py:68-140.
    """
    num_pos = len(set(ecs.i.unique()) | set(ecs.j.unique()))
    if isinstance(num_pairs, float):
        num_pairs = int(ceil(num_pairs * num_pos))

    top_ecs = (
        ecs.query("abs(i-j) >= {}".format(min_seqdist))
        .sort_values(by=score, ascending=False)
        .iloc[0:num_pairs]
    )
    if len(top_ecs) == 0:
        raise ValueError(
            "No EC pairs at sequence separation >= {} — cannot "
            "compute enrichment (table covers {} pairs)".format(
                min_seqdist, len(ecs)
            )
        )

    # count each pair in both directions so the groupby sums the full
    # EC degree of every position
    flipped = top_ecs.rename(
        columns={"i": "j", "j": "i", "A_i": "A_j", "A_j": "A_i"}
    )
    stacked = pd.concat([top_ecs, flipped])

    ec_sums = pd.DataFrame(stacked.groupby(["i", "A_i"]).sum())
    avg_degree = top_ecs.loc[:, score].sum() / len(top_ecs)
    ec_sums.loc[:, "enrichment"] = ec_sums.loc[:, score] / avg_degree

    e = ec_sums.reset_index().loc[:, ["i", "A_i", "enrichment"]]
    return e.sort_values(by="enrichment", ascending=False)


class LegacyScoreMixtureModel:
    """Normal + lognormal mixture over EC scores; posterior of the
    lognormal (signal) tail. Superseded by ScoreMixtureModel.

    Parity: reference pairs.py:143-369 (same initialization, objective,
    Nelder-Mead optimizer, and failure condition).
    """

    def __init__(self, x, clamp_mu=False, max_fun=10000, max_iter=1000):
        x = np.asarray(x, dtype=float)
        self.params = self._learn_params(x, clamp_mu, max_fun, max_iter)

    @classmethod
    def _gaussian(cls, x, params):
        mu, sigma, q = params[:3]
        return q * stats.norm.pdf(x, loc=mu, scale=sigma)

    @classmethod
    def _lognormal(cls, x, params):
        q, logmu, logsigma = params[2:]
        prob = np.zeros(len(x))
        xpos = x > 0
        tail = stats.norm.pdf(
            np.log(x[xpos]), loc=logmu, scale=logsigma
        )
        prob[xpos] = (1 - q) * tail / x[xpos]
        return prob

    @classmethod
    def _learn_params(cls, x, clamp_mu, max_fun, max_iter):
        logsigma = 0.4
        start = np.array([
            0.0,                                   # mu (normal)
            np.std(x),                             # sigma (normal)
            1.0,                                   # class weight q
            np.percentile(x, 75) - logsigma ** 2 / 2,  # logmu
            logsigma,
        ])

        def neg_loglk(params):
            if clamp_mu:
                params[0] = 0
            dens = cls._gaussian(x, params) + cls._lognormal(x, params)
            return -np.sum(np.log(dens))

        coeff = op.fmin(
            neg_loglk, start, maxfun=max_fun, maxiter=max_iter, disp=False
        )
        if clamp_mu:
            coeff[0] = 0

        q = coeff[2]
        if q >= 1 or np.isinf(q) or np.isneginf(q):
            raise ValueError("No tail, fit failed. q={}".format(q))
        return coeff

    def probability(self, x, plot=False):
        """Posterior probability of being in the lognormal tail."""
        x = np.asarray(x, dtype=float)
        p_log = self._lognormal(x, self.params)
        p_gauss = self._gaussian(x, self.params)
        posterior = p_log / (p_log + p_gauss)

        if plot:
            self._plot(x, posterior, p_log, p_gauss)
        return posterior

    def _plot(self, x, posterior, p_log, p_gauss):
        import matplotlib.pyplot as plt

        plt.figure(figsize=(12, 8))
        n_ecs, edges = np.histogram(x, 1000, density=True)
        mid = 0.5 * (edges[:-1] + edges[1:])
        plt.plot(mid, n_ecs, "-", color="#fdc832", linewidth=1)
        plt.plot(x, posterior, "-k", linewidth=2)
        plt.plot(x, p_log, "r", linewidth=1)
        plt.plot(x, p_gauss, "b", linewidth=1)
        plt.xlabel("EC scores")
        plt.ylabel("PDF")


class ScoreMixtureModel:
    """Skew-normal (noise) + lognormal (signal) mixture fit by EM;
    posterior of the lognormal tail.

    Parity: reference pairs.py:372-639 (same EM schedule: closed-form
    M-steps for mixing fraction and lognormal component, Nelder-Mead for
    the zero-mean-constrained skew normal).
    """

    def __init__(self, x):
        x = np.asarray(x, dtype=float)
        self.params = self._learn_params(x)

    @classmethod
    def skewnorm_pdf(cls, x, location, scale, skew):
        t = (x - location) / scale
        return 2 / scale * stats.norm.pdf(t) * stats.norm.cdf(skew * t)

    @classmethod
    def lognorm_pdf(cls, x, logmu, logsig):
        density = np.zeros(len(x))
        xpos = x > 0
        density[xpos] = stats.norm.pdf(
            np.log(x[xpos]), loc=logmu, scale=logsig
        ) / x[xpos]
        return density

    @classmethod
    def skewnorm_constraint(cls, scale, skew):
        """Location that gives the skew normal zero mean."""
        return -scale * skew / np.sqrt(1 + skew ** 2) * np.sqrt(2 / np.pi)

    @classmethod
    def mixture_pdf(cls, x, p, scale, skew, logmu, logsig):
        location = cls.skewnorm_constraint(scale, skew)
        return (
            p * cls.skewnorm_pdf(x, location, scale, skew)
            + (1 - p) * cls.lognorm_pdf(x, logmu, logsig)
        )

    @classmethod
    def posterior_signal(cls, x, p, scale, skew, logmu, logsig):
        total = cls.mixture_pdf(x, p, scale, skew, logmu, logsig)
        posterior = np.zeros(total.shape)
        signal = cls.lognorm_pdf(x, logmu, logsig)
        xpos = x > 0
        posterior[xpos] = (1 - p) * signal[xpos] / total[xpos]
        return posterior

    @classmethod
    def _learn_params(cls, x, max_iter=200, tolerance=1e-4):
        if len(x) == 0 or np.max(x) <= 0:
            # the lognormal tail needs positive mass: np.log(max(x))
            # would crash on empty input and degenerate to NaN
            # parameters on all-nonpositive scores
            raise ValueError(
                "Cannot fit the score mixture model: need at least "
                "one positive score (got {} scores)".format(len(x))
            )
        # (mixing fraction p, sn scale, sn skew, ln mean, ln stddev)
        theta = np.array([0.5, np.std(x), 0.0, np.log(np.max(x)), 0.1])

        def loglk(params):
            return np.sum(np.log(cls.mixture_pdf(x, *params)))

        cur_loglk = loglk(theta)
        pos_ix = x > 0
        log_score = np.log(x[pos_ix])

        for _ in range(max_iter):
            prev_theta = theta.copy()

            # E step: responsibility of the noise component
            z = 1 - cls.posterior_signal(x, *theta)

            # M step — closed form for p and the lognormal component
            theta[0] = np.mean(z)
            zc = 1 - z[pos_ix]
            theta[3] = np.sum(zc * log_score) / np.sum(zc)
            theta[4] = np.sqrt(
                np.sum(zc * (log_score - theta[3]) ** 2) / zc.sum()
            )

            # M step — numerical for the constrained skew normal
            def neg_weighted_loglk(params):
                loc = cls.skewnorm_constraint(params[0], params[1])
                with np.errstate(divide="ignore", invalid="ignore"):
                    terms = z * np.log(
                        cls.skewnorm_pdf(x, loc, *params)
                    )
                # a zero-responsibility point contributes nothing even
                # where the pdf underflows to 0: 0 * -inf is NaN and
                # would poison the whole Nelder-Mead objective (latent
                # in the reference, pairs.py:593-601). Positive-weight
                # underflows still drive the objective to +inf, which
                # correctly rejects the trial step.
                return -np.sum(np.where(z > 0, terms, 0.0))

            theta[1:3] = op.fmin(neg_weighted_loglk, theta[1:3], disp=False)

            with np.errstate(divide="ignore", invalid="ignore"):
                new_loglk = loglk(theta)

            # degenerate updates (e.g. the skew-normal scale collapsing
            # to 0 on near-singular data, which cascades NaN through
            # the next E step — latent in the reference) stop the EM
            # at the last healthy iterate instead of returning NaN
            # parameters; on healthy data this never fires and the
            # trajectory is unchanged
            if not (np.isfinite(new_loglk)
                    and np.all(np.isfinite(theta))):
                theta = prev_theta
                break

            delta = new_loglk - cur_loglk
            cur_loglk = new_loglk
            if delta <= tolerance:
                break

        return theta

    def probability(self, x, plot=False):
        """Posterior probability of being in the lognormal tail."""
        x = np.asarray(x, dtype=float)
        posterior = self.posterior_signal(x, *self.params)

        if plot:
            import matplotlib.pyplot as plt

            plt.hist(x, density=True, bins=50, color="k")
            plt.plot(x, self.mixture_pdf(x, *self.params), color="r", lw=3)
            plt.plot(x, posterior, color="gold", lw=3)

        return posterior


class EVComplexScoreModel:
    """Unnormalized EVcomplex score: cn / |min cn| (Hopf, Schärfe et al.,
    2014). Parity: reference pairs.py:642-682."""

    def __init__(self, x):
        self.x = np.asarray(x, dtype=float)

    def probability(self, x, plot=False):
        return np.asarray(x, dtype=float) / abs(np.min(self.x))


def add_mixture_probability(ecs, model="skewnormal", score="cn",
                            clamp_mu=False, plot=False):
    """Add a "probability" column from the selected significance model.

    Parity: reference pairs.py:685-733.
    """
    ec_prob = deepcopy(ecs)
    scores = ecs.loc[:, score].values

    if model == "skewnormal":
        mm = ScoreMixtureModel(scores)
    elif model == "normal":
        mm = LegacyScoreMixtureModel(scores, clamp_mu)
    elif model == "evcomplex":
        mm = EVComplexScoreModel(scores)
    else:
        raise ValueError(
            "Invalid model selection, valid options are: "
            "skewnormal, normal, evcomplex"
        )

    ec_prob.loc[:, "probability"] = mm.probability(
        ec_prob.loc[:, score].values, plot=plot
    )
    return ec_prob


def add_freqs_to_ec_table(ecs, freqs):
    """Merge per-position frequency/conservation info into an EC table.

    Adds freq_i/gap_i/cons_i (and _j) columns by joining on (i, A_i) and
    (j, A_j). Parity: reference pairs.py:801-846.
    """
    freqs = freqs.rename(
        columns={"-": "gap_i", "conservation": "cons_i"}
    ).dropna()

    # frequency of the target residue at each position, via row-wise lookup
    # into the per-symbol columns
    freqs = freqs.assign(
        freq_i=[row[row["A_i"]] for _, row in freqs.iterrows()]
    )

    freqs_i = freqs[["i", "A_i", "freq_i", "gap_i", "cons_i"]]
    freqs_j = freqs_i.rename(
        columns={c: c.replace("i", "j") for c in freqs_i.columns}
    )

    merged = ecs.merge(freqs_i, on=["i", "A_i"]).merge(
        freqs_j, on=["j", "A_j"]
    )
    if len(merged) != len(ecs):
        # an assert would vanish under python -O and silently drop
        # the unmatched EC rows from every downstream count
        raise ValueError(
            "Frequency annotation dropped {} of {} EC rows: the EC "
            "table references positions absent from the frequencies "
            "table".format(len(ecs) - len(merged), len(ecs))
        )
    return merged


def mad_outlier_score(x):
    """Robust z-score: (x - median) / MAD. Parity: pairs.py:849-872."""
    x = np.asarray(x, dtype=float)
    return (x - np.median(x)) / median_absolute_deviation(x)


# ---------------------------------------------------------------------------
# logistic-regression rescorer
# ---------------------------------------------------------------------------

class LinearLogisticModel:
    """Binary logistic-regression evaluator (native, no sklearn).

    Evaluates decision(X) = X @ coef + intercept and
    p(true) = sigmoid(decision). Round-trips the serialized classifier
    dict schema, carrying sklearn-only training settings unread.
    """

    def __init__(self, coef, intercept, classes=(0, 1),
                 classifier_settings=None, n_iter=None):
        coef_arr = np.asarray(coef, dtype=float)
        intercept_arr = np.asarray(intercept, dtype=float).reshape(-1)
        classes = list(classes)
        # flattening a multi-class model's coef_/intercept_ would
        # silently compute garbage — fail at construction instead
        if ((coef_arr.ndim == 2 and coef_arr.shape[0] != 1)
                or intercept_arr.size != 1 or len(classes) != 2):
            raise ValueError(
                "Only binary single-row logistic models are "
                "supported (coef_ shape {}, {} intercept(s), "
                "classes {})".format(
                    coef_arr.shape, intercept_arr.size, classes
                )
            )
        self.coef = coef_arr.reshape(-1)
        self.intercept = float(intercept_arr[0])
        self.classes = classes
        self.classifier_settings = classifier_settings or {}
        # sklearn training metadata, carried so serialize(deserialize)
        # is lossless on the schema
        self.n_iter = list(n_iter) if n_iter is not None else [0]

    @classmethod
    def from_dict(cls, params):
        """Deserialize from the YAML schema; returns (model,
        feature_names)."""
        settings = params["model_settings"]
        model = cls(
            coef=settings["coef_"],
            intercept=settings["intercept_"],
            classes=settings.get("classes_", [0, 1]),
            classifier_settings=params.get("classifier_settings"),
            n_iter=settings.get("n_iter_"),
        )
        return model, params.get("feature_names")

    def to_dict(self, feature_names=None):
        """Serialize into the YAML schema."""
        params = {
            "classifier_settings": dict(self.classifier_settings),
            "model_settings": {
                "classes_": list(self.classes),
                "intercept_": [self.intercept],
                "coef_": [self.coef.tolist()],
                "n_iter_": list(self.n_iter),
            },
        }
        if feature_names is not None:
            params["feature_names"] = list(feature_names)
        return params

    def decision_function(self, X):
        return np.asarray(X, dtype=float) @ self.coef + self.intercept

    def predict_proba_true(self, X):
        # expit is the overflow-safe sigmoid (exp(-d) overflows a
        # float64 for strongly negative decisions)
        from scipy.special import expit

        return expit(self.decision_function(X))


def logreg_classifier_to_dict(classifier, feature_names=None):
    """Serialize a logistic-regression classifier into the YAML-able
    dict schema.

    Accepts a LinearLogisticModel, or any object with the
    sklearn-style attributes classes_/intercept_/coef_/n_iter_ and
    get_params() (e.g. an actual sklearn LogisticRegression).
    """
    if isinstance(classifier, LinearLogisticModel):
        return classifier.to_dict(feature_names=feature_names)

    params = {
        "classifier_settings": classifier.get_params(),
        "model_settings": {
            attrib: np.asarray(getattr(classifier, attrib)).tolist()
            for attrib in ["classes_", "intercept_", "coef_", "n_iter_"]
        },
    }
    if feature_names is not None:
        params["feature_names"] = list(feature_names)
    return params


def logreg_classifier_from_dict(params):
    """Deserialize the classifier dict schema into a
    (LinearLogisticModel, feature_names) pair (sklearn-free)."""
    return LinearLogisticModel.from_dict(params)


class LogisticRegressionScorer:
    """Rescore EC tables with a logistic-regression model fit to a large
    set of reference runs.

    Parity: reference pairs.py:875-1047 — identical features (mad_score,
    conservation/gap extrema, log10 num_sites, log10 theta-normalized
    N_eff/L and N_eff/L²), identical low-N_eff fallback.
    """

    def __init__(self, logreg_model_file=None, min_n_eff_over_l=0.375):
        if logreg_model_file is None:
            logreg_model_file = DEFAULT_LOGREG_MODEL_FILE

        serialized = read_config_file(logreg_model_file)
        self.classifier, self.feature_names = LinearLogisticModel.from_dict(
            serialized
        )
        self.min_n_eff_over_l = min_n_eff_over_l

    @classmethod
    def _create_full_data_table(cls, ecs, freqs, theta,
                                effective_sequences, num_sites):
        """Annotate the EC table with all classifier input features."""
        meff_over_l_norm = effective_sequences / num_sites / theta
        meff_over_l2_norm = effective_sequences / num_sites ** 2 / theta

        ecs = add_freqs_to_ec_table(ecs, freqs)
        return ecs.assign(
            num_sites_log=np.log10(num_sites),
            min_gap=np.minimum(ecs.gap_i, ecs.gap_j),
            max_gap=np.maximum(ecs.gap_i, ecs.gap_j),
            min_cons=np.minimum(ecs.cons_i, ecs.cons_j),
            max_cons=np.maximum(ecs.cons_i, ecs.cons_j),
            meff_over_l_norm_log=np.log10(meff_over_l_norm),
            meff_over_l2_norm_log=np.log10(meff_over_l2_norm),
        )

    def score(self, ecs, freqs, theta, effective_sequences,
              num_sites=None, score="cn"):
        """Rescore a full, unfiltered EC table.

        Returns the table with mad_score/probability/score columns added,
        sorted by "score" descending. If N_eff/L/theta is below the
        reliability threshold, score := input score and probability := 0.
        """
        if num_sites is None:
            num_sites = len(set(ecs.i.unique()) | set(ecs.j.unique()))

        if effective_sequences / num_sites / theta < self.min_n_eff_over_l:
            return ecs.assign(score=ecs[score], probability=0)

        ecs = ecs.assign(mad_score=mad_outlier_score(ecs[score]))
        ecs_full = self._create_full_data_table(
            ecs, freqs, theta, effective_sequences, num_sites
        )

        missing = [
            f for f in self.feature_names if f not in ecs_full.columns
        ]
        if missing:
            # reindex would insert all-NaN columns and the native
            # matmul would propagate them into every probability
            # (sklearn raised here; match that loudly)
            raise ValueError(
                "Scoring model requires feature(s) [{}] absent from "
                "the computed feature table (available: {})".format(
                    ", ".join(missing), ", ".join(ecs_full.columns)
                )
            )
        X = ecs_full.loc[:, list(self.feature_names)].values
        ecs_final = ecs_full.assign(
            score=self.classifier.decision_function(X),
            probability=self.classifier.predict_proba_true(X),
        ).sort_values(by="score", ascending=False)

        return ecs_final[list(ecs.columns) + ["probability", "score"]]
