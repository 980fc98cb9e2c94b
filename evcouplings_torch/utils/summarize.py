"""
Run-level summary statistics and plots for `evcouplings_torch` app runs
(port of evcouplings_tpu/utils/summarize.py; aggregates all sub-jobs of
a batch sweep; invoked after each sub-job).

Parity target of the JAX module: reference
evcouplings/utils/summarize.py — protein_monomer (:27),
_protein_monomer_plot (:121), protein_complex (:218), CLI (:363).
Concurrent sub-jobs serialize writes to the shared summary files via
filelock. matplotlib is imported only where the monomer summary figure
is drawn (_write_monomer_plot): without it protein_monomer raises
ImportError before it writes anything; protein_complex draws nothing.
"""

from collections import defaultdict

import click
import filelock
import pandas as pd

from evcouplings_torch.utils.config import (
    InvalidParameterError,
    read_config_file,
)
from evcouplings_torch.utils.constants import FINAL_CONFIG_SUFFIX
from evcouplings_torch.utils.system import valid_file

CONTEXT_SETTINGS = dict(help_option_names=["-h", "--help"])


def _load_subjob_state(cfg_file):
    """(run config, final-state outcfg, pinned stats row) of one
    finished sub-job, or None while it is still running / crashed.
    stat_df is None when the statistics file itself is absent (the
    sub-job's other artifacts may still be summarizable)."""
    if not valid_file(cfg_file):
        return None
    run_cfg = read_config_file(cfg_file)
    state_file = run_cfg["global"]["prefix"] + FINAL_CONFIG_SUFFIX
    if not valid_file(state_file):
        return None
    state = read_config_file(state_file)
    stat_df = None
    if valid_file(state["statistics_file"]):
        stat_df = pd.read_csv(state["statistics_file"])
        if state["effective_sequences"] is not None:
            stat_df.loc[0, "N_eff"] = state["effective_sequences"]
    return run_cfg, state, stat_df


def _configured_min_seqdist(run_cfg, default=6):
    """min_sequence_distance from the compare stage, falling back to
    the couplings stage, then to the given default."""
    couplings_dist = (run_cfg.get("couplings") or {}).get(
        "min_sequence_distance", default
    )
    return (run_cfg.get("compare") or {}).get(
        "min_sequence_distance", couplings_dist
    )


def protein_monomer(prefix, configs):
    """Aggregate monomer sub-job results: alignment statistics table
    (threshold, N_eff, significant ECs, precision) + summary plot."""
    MIN_PROBABILITY = 0.9

    ali_table = pd.DataFrame()
    data = defaultdict(lambda: defaultdict())

    for cfg_file in configs:
        # sub-job may not have finished (or crashed) yet
        loaded = _load_subjob_state(cfg_file)
        if loaded is None:
            continue
        C, R, stat_df = loaded

        # sweeps over the `existing` protocol have no search threshold
        domain_threshold = C["align"].get("domain_threshold")
        sub_index = (domain_threshold, C["global"]["prefix"])
        data[sub_index].update(
            identities=R["identities_file"],
            frequencies=R["frequencies_file"],
            minimum_column_coverage=C["align"][
                "minimum_column_coverage"],
        )

        # identity/gap panels still render above without a stats row
        if stat_df is None:
            continue

        stat_df.loc[0, "domain_threshold"] = domain_threshold
        L = stat_df.loc[0, "num_cov"]

        ec_file = R.get("ec_file", "")
        if valid_file(ec_file):
            ecs = pd.read_csv(ec_file)
            min_seq_dist = _configured_min_seqdist(C)
            stat_df.loc[0, "num_significant"] = len(ecs.query(
                "abs(i-j) >= @min_seq_dist and "
                "probability >= @MIN_PROBABILITY"
            ))

        ec_comp_file = R.get("ec_compared_longrange_file", "")
        if valid_file(ec_comp_file):
            ec_comp = pd.read_csv(ec_comp_file)
            if len(ec_comp) > L:
                stat_df.loc[0, "precision"] = (
                    ec_comp.iloc[L]["precision"]
                )

        ali_table = pd.concat([ali_table, stat_df])

    if len(ali_table) == 0:
        return ali_table

    ali_table = ali_table.sort_values(by="domain_threshold")
    _add_average_identities(ali_table, data)

    # locks serialize against concurrently finishing sub-jobs
    _write_monomer_plot(
        ali_table, data, prefix + "_job_statistics_summary.pdf")

    table_file = prefix + "_job_statistics_summary.csv"
    with filelock.FileLock(table_file + ".lock"):
        ali_table.to_csv(table_file, index=False, float_format="%.3f")

    return ali_table


def _style_panel(ax, title, xlabel, ylabel, ylim=None):
    """Apply the shared panel styling of the summary figure."""
    ax.set_title(title, fontsize=16)
    ax.set_xlabel(xlabel)
    ax.set_ylabel(ylabel)
    if ylim is not None:
        ax.set_ylim(*ylim)


def _add_average_identities(ali_table, data):
    """The mean identity to the query of each sub-job with an
    identities file, as the table's average_identity column."""
    for (threshold, subjob), subdata in sorted(data.items()):
        if valid_file(subdata["identities"]):
            ids = pd.read_csv(
                subdata["identities"]
            ).identity_to_query.dropna()
            ali_table.loc[
                ali_table.prefix == subjob, "average_identity"
            ] = ids.mean()


def _write_monomer_plot(ali_table, data, plot_file):
    """Draw the monomer summary figure and save it as plot_file (under
    its lock); raises ImportError when matplotlib is not installed."""
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the monomer summary plot {} needs matplotlib, which is not "
            "installed".format(plot_file)) from e
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig = _protein_monomer_plot(plt, ali_table, data)
    with filelock.FileLock(plot_file + ".lock"):
        fig.savefig(plot_file, bbox_inches="tight")
    plt.close(fig)


def _protein_monomer_plot(plt, ali_table, data):
    """Five-panel monomer summary plot (coverage, identity
    distribution, gap statistics, significant ECs, precision)."""
    fig = plt.figure(figsize=(15, 15))
    grid = fig.add_gridspec(3, 2)
    ax_cov = fig.add_subplot(grid[0, 0])
    ax_distr = fig.add_subplot(grid[0, 1])
    ax_gaps = fig.add_subplot(grid[1, :])       # full-width middle row
    ax_sig = fig.add_subplot(grid[2, 0])
    ax_comp = fig.add_subplot(grid[2, 1])

    thresholds = ali_table.domain_threshold

    # panel 1: effective sequences + coverage vs search threshold,
    # two y-axes
    _style_panel(ax_cov, "Sequences and coverage",
                 "Domain inclusion threshold",
                 "# effective sequences / L")
    ax_cov.plot(thresholds, ali_table.N_eff / ali_table.num_cov,
                "ok-", label="# Sequences")
    ax_cov.legend(loc="lower left")
    twin = ax_cov.twinx()
    twin.plot(thresholds, ali_table.num_cov / ali_table.seqlen,
              "o-", color="#2079b4", label="Coverage")
    twin.set_ylabel("Coverage (% of region)")
    twin.set_ylim(0, 1)
    twin.legend(loc="lower right")

    # panels 2+3: per-sub-job identity distribution and per-column
    # gap statistics
    for (threshold, subjob), subdata in sorted(data.items()):
        if valid_file(subdata["identities"]):
            ids = pd.read_csv(
                subdata["identities"]
            ).identity_to_query.dropna()
            ax_distr.hist(
                ids, histtype="step", range=(0, 1.0), bins=100,
                density=True, cumulative=True, linewidth=3,
                label=str(threshold),
            )

        if valid_file(subdata["frequencies"]):
            freqs = pd.read_csv(subdata["frequencies"])
            ax_gaps.plot(freqs.i, 1 - freqs.loc[:, "-"], "o",
                         linewidth=3, label=str(threshold))
            mincov = subdata["minimum_column_coverage"]
            if mincov is not None:
                # None = column-coverage filtering disabled
                ax_gaps.axhline(
                    mincov / 100 if mincov > 1 else mincov,
                    ls="--", color="k",
                )

    _style_panel(ax_distr, "Sequence identity distribution",
                 "% sequence identity to query", "", ylim=(0, 1))
    ax_distr.set_xlim(0, 1)
    ax_distr.legend()

    _style_panel(ax_gaps, "Gap statistics", "Sequence index",
                 "Column coverage (1 - % gaps)", ylim=(0, 1))
    ax_gaps.autoscale(enable=True, axis="x", tight=True)
    ax_gaps.legend(loc="best")

    # panels 4+5: EC significance and 3D agreement vs threshold
    _style_panel(ax_sig, "Significant ECs",
                 "Domain inclusion threshold",
                 "Fraction of significant ECs (% of L)")
    if "num_significant" in ali_table.columns:
        ax_sig.plot(thresholds,
                    ali_table.num_significant / ali_table.num_cov,
                    "ok-")

    _style_panel(ax_comp, "Comparison to 3D (top L ECs)",
                 "Domain inclusion threshold", "EC precision",
                 ylim=(0, 1))
    if "precision" in ali_table.columns:
        ax_comp.plot(thresholds, ali_table.precision, "ok-")

    return fig


def protein_complex(prefix, configs):
    """Aggregate complex sub-job results (concatenation statistics,
    significant monomer/inter ECs, segmentwise precision)."""
    MIN_PROBABILITY = 0.9
    NUM_INTER = 5
    FIRST_SEGMENT = "A_1"
    SECOND_SEGMENT = "B_1"

    ali_table = pd.DataFrame()

    for cfg_file in configs:
        loaded = _load_subjob_state(cfg_file)
        if loaded is None or loaded[2] is None:
            continue
        C, R, stat_df = loaded

        ec_file = R.get("ec_file", "")
        ec_comp_file = R.get("ec_compared_longrange_file", "")
        first_stat_file = R.get("first_statistics_file", "")
        second_stat_file = R.get("second_statistics_file", "")

        concat_stat_file = R.get("concatentation_statistics_file", "")
        if valid_file(concat_stat_file):
            concat_row = pd.read_csv(concat_stat_file).loc[0]
            stat_df.loc[0, "first_n_seqs"] = int(
                concat_row["num_seqs_1"])
            stat_df.loc[0, "second_n_seqs"] = int(
                concat_row["num_seqs_2"])
            for med_col in ("median_num_per_species_1",
                            "median_num_per_species_2"):
                stat_df.loc[0, med_col] = concat_row[med_col]

        if valid_file(ec_file):
            ecs = pd.read_csv(ec_file)
            min_seq_dist = _configured_min_seqdist(C)
            stat_df.loc[0, "num_significant"] = int(len(ecs.query(
                "abs(i-j) >= @min_seq_dist and "
                "probability >= @MIN_PROBABILITY"
            )))

            inter_ecs = ecs.query("segment_i != segment_j")
            if len(inter_ecs) > 0:
                stat_df.loc[0, "top_inter_rank"] = int(
                    inter_ecs.index[0]
                )

        if valid_file(ec_comp_file):
            ec_comp = pd.read_csv(ec_comp_file)
            ec_comp_1 = ec_comp.query(
                "segment_i == segment_j == @FIRST_SEGMENT"
            )
            ec_comp_2 = ec_comp.query(
                "segment_i == segment_j == @SECOND_SEGMENT"
            )
            ec_comp_inter = ec_comp.query("segment_i != segment_j")

            if valid_file(first_stat_file) and valid_file(
                second_stat_file
            ):
                L_1 = pd.read_csv(first_stat_file).loc[0, "num_cov"]
                L_2 = pd.read_csv(second_stat_file).loc[0, "num_cov"]

                if len(ec_comp_1) > L_1:
                    stat_df.loc[0, "first_monomer_precision"] = (
                        ec_comp_1.iloc[L_1]["segmentwise_precision"]
                    )
                if len(ec_comp_2) > L_2:
                    stat_df.loc[0, "second_monomer_precision"] = (
                        ec_comp_2.iloc[L_2]["segmentwise_precision"]
                    )
                if len(ec_comp_inter) > NUM_INTER:
                    stat_df.loc[0, "inter_precision"] = (
                        ec_comp_inter.iloc[NUM_INTER][
                            "segmentwise_precision"
                        ]
                    )

        ali_table = pd.concat([ali_table, stat_df])

    table_file = prefix + "_job_statistics_summary.csv"
    with filelock.FileLock(table_file + ".lock"):
        ali_table.to_csv(table_file, index=False, float_format="%.3f")

    return ali_table


PIPELINE_TO_SUMMARIZER = {
    "protein_monomer": protein_monomer,
    "protein_complex": protein_complex,
}


@click.command(context_settings=CONTEXT_SETTINGS)
@click.argument("pipeline", nargs=1, required=True)
@click.argument("prefix", nargs=1, required=True)
@click.argument("configs", nargs=-1)
def app(**kwargs):
    """Create summary statistics for evcouplings pipeline runs."""
    try:
        summarizer = PIPELINE_TO_SUMMARIZER[kwargs["pipeline"]]
    except KeyError:
        raise InvalidParameterError(
            "Not a valid pipeline, valid selections are: {}".format(
                ",".join(PIPELINE_TO_SUMMARIZER.keys())
            )
        )

    summarizer(kwargs["prefix"], kwargs["configs"])


if __name__ == "__main__":
    app()
