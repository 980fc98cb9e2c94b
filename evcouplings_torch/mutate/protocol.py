"""
Mutation-effect (EVmutation) stage protocols (port of
evcouplings_tpu/mutate/protocol.py). The `standard` protocol is ported;
`complex` needs the complex pipeline (ROADMAP A19c) and raises
NotImplementedError. The interactive bokeh matrix plots are produced
only when the optional bokeh package is installed; the static matplotlib
plots need matplotlib, which is imported where they are drawn.
"""

import pandas as pd

from evcouplings_torch.couplings.model import CouplingsModel
from evcouplings_torch.mutate.calculations import (
    predict_mutation_table,
    single_mutant_matrix,
)
from evcouplings_torch.utils.config import (
    InvalidParameterError,
    check_required,
)
from evcouplings_torch.utils.system import (
    create_prefix_folders,
    verify_resources,
)
from evcouplings_torch.visualize import mutations as vis_mutations


def _plot_models(models_and_types, prefix, outcfg):
    """Render interactive (optional) + static mutation matrix plots
    (matplotlib is imported here: the rest of the stage runs without
    it)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    try:
        from bokeh.io import output_file, save
        from bokeh.plotting import figure as _bokeh_figure  # noqa: F401
        have_bokeh = True
    except ImportError:
        have_bokeh = False

    for model, type_ in models_and_types:
        filename = prefix + "_{}_model".format(type_.lower())

        if have_bokeh:
            # interactive plots are strictly optional: a broken or
            # partially-installed bokeh must degrade to the static
            # matplotlib artifact, not crash the mutate stage
            try:
                output_file(filename + ".html",
                            "{} model".format(type_))
                fig = vis_mutations.plot_mutation_matrix(
                    model, engine="bokeh"
                )
                save(fig)
            except (ImportError, AttributeError, TypeError):
                have_bokeh = False
            else:
                outcfg["mutation_matrix_plot_files"].append(
                    filename + ".html"
                )

        vis_mutations.plot_mutation_matrix(model)
        plt.savefig(filename + ".pdf", bbox_inches="tight")
        plt.close("all")
        outcfg["mutation_matrix_plot_files"].append(filename + ".pdf")


def _begin_stage(kwargs):
    """Shared protocol entry: model file check, prefix folders, and the
    base output state."""
    verify_resources(
        "Model parameter file does not exist", kwargs["model_file"]
    )
    prefix = kwargs["prefix"]
    create_prefix_folders(prefix)
    return {
        "mutation_matrix_file": prefix + "_single_mutant_matrix.csv",
        "mutation_matrix_plot_files": [],
    }


def _single_mutant_table(tagged_models, matrix_file):
    """Full single-mutant landscape: the scan runs on the first model,
    every further model adds its prediction_<tag> column; the table is
    persisted to matrix_file."""
    (lead_tag, lead_model), *others = tagged_models
    table = single_mutant_matrix(
        lead_model, output_column="prediction_" + lead_tag
    )
    for tag, model in others:
        table = predict_mutation_table(
            model, table, "prediction_" + tag
        )
    table.to_csv(matrix_file, index=False)
    return table


def _write_pymol_scripts(singles, tagged_models, prefix, outcfg,
                         **script_kwargs):
    """One .pml effect-visualization script per model tag."""
    outcfg["mutations_epistatic_pml_files"] = []
    for tag, _ in tagged_models:
        script_file = prefix + "_{}_model.pml".format(tag)
        vis_mutations.mutation_pymol_script(
            singles, script_file,
            effect_column="prediction_" + tag,
            **script_kwargs,
        )
        outcfg["mutations_epistatic_pml_files"].append(script_file)


def _score_dataset(data, scorers, out_file):
    """Add one prediction column per (model, column) pair to an
    experimental mutation dataset and persist it."""
    for model, column in scorers:
        data = predict_mutation_table(model, data, column)
    data.to_csv(out_file, index=False)


def standard(**kwargs):
    """Protocol: mutation-effect calculation for protein monomers
    (epistatic + independent model)."""
    check_required(
        kwargs, ["prefix", "model_file", "mutation_dataset_file"]
    )
    prefix = kwargs["prefix"]
    outcfg = _begin_stage(kwargs)

    epistatic = CouplingsModel(kwargs["model_file"])
    independent = epistatic.to_independent_model()
    tagged = [("epistatic", epistatic), ("independent", independent)]

    _plot_models(
        [(epistatic, "Epistatic"), (independent, "Independent")],
        prefix, outcfg,
    )

    singles = _single_mutant_table(
        tagged, outcfg["mutation_matrix_file"]
    )
    _write_pymol_scripts(singles, tagged, prefix, outcfg)

    # score an experimental dataset if given
    dataset_file = kwargs["mutation_dataset_file"]
    if dataset_file is not None:
        verify_resources("Dataset file does not exist", dataset_file)
        outcfg["mutation_dataset_predicted_file"] = (
            prefix + "_dataset_predicted.csv"
        )
        _score_dataset(
            pd.read_csv(dataset_file, comment="#"),
            [(epistatic, "prediction_epistatic"),
             (independent, "prediction_independent")],
            outcfg["mutation_dataset_predicted_file"],
        )

    return outcfg


def complex(**kwargs):
    """Not ported yet (ROADMAP A19c): mutation effects for complexes."""
    raise NotImplementedError(
        "mutate protocol 'complex' needs the complex pipeline, which is "
        "not ported yet (ROADMAP A19c)")


PROTOCOLS = {
    # standard EVmutation protocol
    "standard": standard,
    # EVmutation protocol for complexes
    "complex": complex,
}


def run(**kwargs):
    """Dispatch to the mutate protocol named by kwargs["protocol"]."""
    check_required(kwargs, ["protocol"])

    if kwargs["protocol"] not in PROTOCOLS:
        raise InvalidParameterError(
            "Invalid protocol selection: "
            "{}. Valid protocols are: {}".format(
                kwargs["protocol"], ", ".join(PROTOCOLS.keys())
            )
        )

    return PROTOCOLS[kwargs["protocol"]](**kwargs)
