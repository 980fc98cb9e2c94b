"""
Residue distance maps on PDB 3D coordinates (port of
evcouplings_tpu/compare/distances.py): DistanceMap with its csv+npy
persistence, contacts, aggregation and structure coverage;
intra_dists, multimer_dists, inter_dists, remap_chains and
remap_complex_chains.

The one device piece is the minimum-atom-distance contraction
(ops/distances.min_atom_distances, float64): DistanceMap.from_coords and
the *_dists functions take `device` (None: the CUDA device, "cpu": the
host) and hand it on. Aggregation across structures stays host numpy
(np.nanmin), as in the JAX package.
"""

from collections import Counter
from copy import deepcopy
from itertools import combinations
from operator import itemgetter

import numpy as np
import pandas as pd

from evcouplings_torch.compare.pdb import load_structures
from evcouplings_torch.ops.distances import min_atom_distances
from evcouplings_torch.utils.constants import AA1_to_AA3
from evcouplings_torch.utils.helpers import find_segments
from evcouplings_torch.utils.system import create_prefix_folders

# separator between distance map id and field name in aggregated
# residue tables
_SEP = "::"

_NON_NUMERIC_IDS_ERROR = (
    "Residue indices must be all numeric for aggregate "
    "function (no insertion codes allowed)"
)


def _majority_secstruct(states):
    """Majority vote over per-structure secondary-structure states;
    ties break toward the lexicographically larger state, which
    prefers H over E over C."""
    tally = Counter(states.dropna())
    if not tally:
        return np.nan
    return max(tally.items(), key=itemgetter(1, 0))[0]


def _numeric_axis_ids(table):
    """Residue ids of one axis as ints (insertion codes refuse)."""
    try:
        return pd.to_numeric(table.id).astype(int)
    except ValueError as err:
        raise ValueError(_NON_NUMERIC_IDS_ERROR) from err


def _aggregate_axis(matrices, axis, intersect):
    """Combine one axis (residues_i / residues_j) of several maps.

    Returns the merged residue table (ids as strings, per-structure
    annotation columns prefixed "<map id>::", secondary structure
    majority-merged) plus, per input map, the (agg_rows, src_rows)
    index arrays that place its matrix block into the aggregate.
    """
    tables = [getattr(m, axis) for m in matrices]
    numeric_ids = [_numeric_axis_ids(t) for t in tables]

    id_sets = [set(v) for v in numeric_ids]
    if intersect:
        joint = set.intersection(*id_sets)
        if not joint:
            raise ValueError(
                "Intersection of positions on axis "
                "is empty, try intersect=False instead "
                "or remove non-overlapping DistanceMap(s)."
            )
    else:
        joint = set.union(*id_sets)

    ordered = sorted(joint)
    agg_row_of = {id_: k for k, id_ in enumerate(ordered)}

    row_maps = []
    for ids in numeric_ids:
        agg_rows, src_rows = [], []
        for src, value in enumerate(ids):
            pos = agg_row_of.get(value)
            if pos is not None:
                agg_rows.append(pos)
                src_rows.append(src)
        row_maps.append((
            np.asarray(agg_rows, dtype=int),
            np.asarray(src_rows, dtype=int),
        ))

    # label each map's annotation columns with its id (or its list
    # position when unset); the separator char is reserved
    labels = [
        str(m.id).replace(_SEP, "") if m.id is not None else k
        for k, m in enumerate(matrices)
    ]

    pieces = []
    for label, table in zip(labels, tables):
        # a previously merged secondary-structure column would be
        # re-merged on iterative aggregation — drop it (the prefixed
        # per-structure columns carry the raw states)
        if len(table.filter(regex=_SEP + "sec_struct_3state").columns):
            table = table.drop(["sec_struct_3state"], axis=1)
        renames = {
            c: "{}{}{}".format(label, _SEP, c)
            for c in table.columns if _SEP not in c
        }
        pieces.append(table.set_index("id").rename(columns=renames))

    stacked = pd.concat(
        pieces, axis=1,
        join="inner" if intersect else "outer", sort=True,
    )
    stacked.index.name = "id"

    axis_table = pd.DataFrame({"id": [str(v) for v in ordered]})

    sse = stacked.filter(regex=_SEP + "sec_struct_3state")
    if len(sse.columns):
        majority = sse.apply(_majority_secstruct, axis=1)
        axis_table = axis_table.merge(
            majority.rename("sec_struct_3state").reset_index(),
            on="id", how="left",
        )

    axis_table = axis_table.merge(
        stacked.reset_index(), on="id", how="left"
    )
    return axis_table, row_maps


class DistanceMap:
    """Pairwise residue distances between two PDB chains (or within
    one chain, symmetric), with csv+npy persistence and aggregation."""

    _id_separator = _SEP

    def __init__(self, residues_i, residues_j, dist_matrix, symmetric):
        self.residues_i = residues_i
        self.residues_j = residues_j
        self.dist_matrix = dist_matrix
        self.symmetric = symmetric

        self.id_map_i = self._row_lookup(residues_i)
        self.id_map_j = self._row_lookup(residues_j)

        # unique identifier used during aggregation
        self.id = None

    @staticmethod
    def _row_lookup(residues):
        return {v: k for k, v in enumerate(residues.id.values)}

    @classmethod
    def _extract_coords(cls, coords):
        """Flatten a chain's atom table into (atom_ranges, xyz) inputs
        for the distance kernel."""
        flat = coords.reset_index(drop=True).reset_index()
        xyz = flat[["x", "y", "z"]].values

        per_residue = flat.groupby("residue_index")["index"]
        atom_ranges = np.stack(
            (per_residue.first().values, per_residue.last().values),
            axis=1,
        )
        return atom_ranges, xyz

    @classmethod
    def from_coords(cls, chain_i, chain_j=None, device=None):
        """Compute a distance map from chain coordinates (symmetric if
        only one chain is given) on `device` (None: the CUDA device)."""
        ranges_i, coords_i = cls._extract_coords(chain_i.coords)

        symmetric = chain_j is None
        if symmetric:
            chain_j = chain_i
            ranges_j, coords_j = ranges_i, coords_i
        else:
            ranges_j, coords_j = cls._extract_coords(chain_j.coords)

        dists = min_atom_distances(
            ranges_i, coords_i, ranges_j, coords_j, symmetric,
            device=device,
        )

        return cls(chain_i.residues, chain_j.residues, dists, symmetric)

    @classmethod
    def from_file(cls, filename):
        """Load a distance map from its <prefix>.csv/.npy file pair."""
        return cls.from_files(filename + ".csv", filename + ".npy")

    @classmethod
    def from_files(cls, residue_table_file, distance_matrix_file):
        """Load with explicit residue-table (.csv) and matrix (.npy)
        paths."""
        residues = pd.read_csv(
            residue_table_file, index_col=0,
            dtype={"id": str, "seqres_id": str, "coord_id": str},
        )
        matrix = np.load(distance_matrix_file)

        # symmetric maps persist one residue table; asymmetric ones
        # stack both axes with an "axis" marker column
        if "axis" not in residues.columns:
            return cls(residues, residues, matrix, True)

        on_i = residues.axis == "i"
        on_j = residues.axis == "j"
        if not (on_i | on_j).all():
            # malformed table: rows with neither axis marker must not
            # silently land in residues_j and desync the matrix shape
            raise ValueError(
                "Residue table {} carries axis values other than "
                "'i'/'j': {}".format(
                    residue_table_file,
                    sorted(set(residues.axis[~(on_i | on_j)])),
                )
            )
        return cls(
            residues[on_i].drop("axis", axis=1),
            residues[on_j].drop("axis", axis=1),
            matrix, False,
        )

    def to_file(self, filename):
        """Persist as <filename>.csv (residue tables) + .npy (matrix);
        returns both paths."""
        if self.symmetric:
            table = self.residues_i
        else:
            table = pd.concat([
                self.residues_i.assign(axis="i"),
                self.residues_j.assign(axis="j"),
            ])

        csv_path = filename + ".csv"
        npy_path = filename + ".npy"
        table.to_csv(csv_path, index=True)
        np.save(npy_path, self.dist_matrix)
        return csv_path, npy_path

    def dist(self, i, j, raise_na=True):
        """Distance of residue pair (i, j); KeyError or NaN for
        identifiers missing from an axis."""
        try:
            row = self.id_map_i[str(i)]
        except KeyError:
            if raise_na:
                raise KeyError(
                    "{} not contained in first axis of distance "
                    "map".format(i)
                ) from None
            return np.nan

        try:
            col = self.id_map_j[str(j)]
        except KeyError:
            if raise_na:
                raise KeyError(
                    "{} not contained in second axis of distance "
                    "map".format(j)
                ) from None
            return np.nan

        return self.dist_matrix[row, col]

    def __getitem__(self, identifiers):
        i, j = identifiers
        return self.dist(i, j, raise_na=True)

    def contacts(self, max_dist=5.0, min_dist=None):
        """Table of residue pairs with max_dist >= distance
        (> min_dist), excluding the diagonal."""
        close = self.dist_matrix <= max_dist
        if min_dist is not None:
            close = close & (self.dist_matrix > min_dist)

        rows, cols = np.nonzero(close)
        offdiag = rows != cols
        rows, cols = rows[offdiag], cols[offdiag]

        return pd.DataFrame({
            "i": self.residues_i.id.values[rows],
            "j": self.residues_j.id.values[cols],
            "dist": self.dist_matrix[rows, cols],
        })

    def transpose(self):
        """Swap the two axes."""
        return DistanceMap(
            self.residues_j, self.residues_i,
            self.dist_matrix.T, self.symmetric,
        )

    @classmethod
    def aggregate(cls, *matrices, intersect=False, agg_func=np.nanmin):
        """Aggregate several distance maps (default: elementwise
        nanmin) over the union (or intersection) of their numeric
        residue ids; secondary structure is merged by majority vote
        with ties preferring H over E over C."""
        flavors = {m.symmetric for m in matrices}
        if len(flavors) > 1:
            raise ValueError(
                "DistanceMaps are mixed symmetric/non-symmetric."
            )

        res_i, maps_i = _aggregate_axis(matrices, "residues_i",
                                        intersect)
        res_j, maps_j = _aggregate_axis(matrices, "residues_j",
                                        intersect)

        if len(res_i) == 0 or len(res_j) == 0:
            raise ValueError(
                "Trying to aggregate distance matrices on empty "
                "set of positions."
            )

        stack = np.full(
            (len(matrices), len(res_i), len(res_j)), np.nan
        )
        for k, m in enumerate(matrices):
            rows_agg, rows_src = maps_i[k]
            cols_agg, cols_src = maps_j[k]
            if not (len(rows_agg) and len(cols_agg)):
                # this map covers none of the aggregated positions on
                # one axis: it contributes all-NaN (ignored by the
                # nan-min), same as the pre-refactor meshgrid path
                continue
            stack[k][np.ix_(rows_agg, cols_agg)] = \
                m.dist_matrix[np.ix_(rows_src, cols_src)]

        return DistanceMap(
            res_i, res_j, agg_func(stack, axis=0), flavors.pop()
        )

    def _axis_coverage(self, axis):
        """{map id: covered residue segments} for one axis."""
        table = getattr(self, "residues_" + axis)
        table = table.assign(id=_numeric_axis_ids(table))
        table = table.set_index("id")

        # aggregated maps carry one prefixed coord_id column per
        # constituent structure; plain maps carry a bare one
        if "coord_id" in table:
            picked = table[["coord_id"]]
        else:
            picked = table.filter(regex=self._id_separator + "coord_id")

        segments = {}
        for name, column in picked.items():
            if name == "coord_id":
                key = self.id
            else:
                key = name.split(self._id_separator)[0]
            segments[key] = find_segments(
                column.dropna().sort_index().index
            )
        return segments

    def structure_coverage(self):
        """Residue segments covered by each constituent structure, as
        (coverage_i, coverage_j, coverage_id) tuples."""
        cov_i = self._axis_coverage("i")
        cov_j = self._axis_coverage("j")
        return [
            (cov_i[k], cov_j[k], k)
            for k in cov_i.keys() & cov_j.keys()
        ]


def _prepare_structures(structures, pdb_id_list, raise_missing=True):
    """Load structures if given as None / directory path."""
    if structures is None or isinstance(structures, str):
        structures = load_structures(
            pdb_id_list, structures, raise_missing
        )
    return structures


def _prepare_chain(structures, pdb_id, pdb_chain, atom_filter, mapping,
                   model=0):
    """Extract chain, apply atom filter, remap to target numbering."""
    chain = structures[pdb_id].get_chain(pdb_chain, model)
    if atom_filter is not None:
        chain = chain.filter_atoms(atom_filter)
    return chain.remap(mapping)


def _usable_hits(hits, structures, raise_missing):
    """Iterate (index, row) over structure hits, skipping entries
    whose structure tolerant loading (raise_missing=False) dropped."""
    for idx, row in hits.iterrows():
        if raise_missing or row["pdb_id"] in structures:
            yield idx, row


def _paired_hits(sifts_result_i, sifts_result_j):
    """All chain pairings of two hit tables that share a PDB entry
    (columns suffixed _i / _j; original row index kept as index_*)."""
    return sifts_result_i.hits.reset_index().merge(
        sifts_result_j.hits.reset_index(),
        on="pdb_id", suffixes=("_i", "_j"),
    )


class _RunningAggregate:
    """The bookkeeping every distance-map aggregation entry point
    (intra/multimer/inter) needs around its per-structure loop: a
    running min-aggregate, optional persistence of each individual
    map under an output prefix, and the final attachment of the
    individual-map file table to the aggregate."""

    def __init__(self, intersect=False, output_prefix=None):
        self.intersect = intersect
        self.output_prefix = output_prefix
        self.agg = None
        self.records = []
        if output_prefix is not None:
            create_prefix_folders(output_prefix)

    def add(self, distmap, **index_fields):
        """Fold one individual map into the aggregate. index_fields
        name the hit(s) it came from; they become both the filename
        suffix and the leading columns of the individual-map table."""
        if self.output_prefix is not None:
            suffix = "_".join(str(v) for v in index_fields.values())
            residue_table, dist_mat = distmap.to_file(
                "{}_{}".format(self.output_prefix, suffix)
            )
            self.records.append({
                **index_fields,
                "residue_table": residue_table,
                "distance_matrix": dist_mat,
            })

        if self.agg is None:
            self.agg = distmap
        else:
            self.agg = DistanceMap.aggregate(
                self.agg, distmap, intersect=self.intersect
            )

    def result(self):
        if self.agg is not None:
            self.agg.individual_distance_map_table = (
                pd.DataFrame(self.records) if self.records else None
            )
        return self.agg


def _require_hits(*sifts_results):
    if any(len(s.hits) == 0 for s in sifts_results):
        raise ValueError(
            "sifts_result is empty (no structure hits, but at least "
            "one required)"
        )


def intra_dists(sifts_result, structures=None, atom_filter=None,
                intersect=False, output_prefix=None, model=0,
                raise_missing=True, device=None):
    """Aggregated intra-chain distance map across all structure hits.

    Attaches aggregated_residue_maps and (with output_prefix)
    individual_distance_map_table to the result.
    """
    _require_hits(sifts_result)
    structures = _prepare_structures(
        structures, sifts_result.hits.pdb_id, raise_missing
    )

    running = _RunningAggregate(intersect, output_prefix)
    per_hit_residues = []

    for idx, hit in _usable_hits(sifts_result.hits, structures,
                                 raise_missing):
        chain = _prepare_chain(
            structures, hit["pdb_id"], hit["pdb_chain"],
            atom_filter, sifts_result.mapping[hit["mapping_index"]],
            model,
        )
        if not len(chain.residues):
            continue

        distmap = DistanceMap.from_coords(chain, device=device)
        distmap.id = idx

        per_hit_residues.append(
            distmap.residues_i.assign(sifts_table_index=idx)
        )
        running.add(distmap, sifts_table_index=idx)

    agg_distmap = running.result()
    if agg_distmap is not None:
        agg_distmap.aggregated_residue_maps = pd.concat(
            per_hit_residues
        ).reset_index(drop=True)
    return agg_distmap


def multimer_dists(sifts_result, structures=None, atom_filter=None,
                   intersect=False, output_prefix=None, model=0,
                   raise_missing=True, device=None):
    """Aggregated homomultimer distance map: distances between all
    pairs of chains hitting the same entity, symmetrized by min over
    both orientations."""
    _require_hits(sifts_result)
    structures = _prepare_structures(
        structures, sifts_result.hits.pdb_id, raise_missing
    )

    running = _RunningAggregate(intersect, output_prefix)
    by_entry = sifts_result.hits.reset_index().groupby("pdb_id")

    for pdb_id, entry_hits in by_entry:
        if not raise_missing and pdb_id not in structures:
            continue

        chains = [
            (
                hit["index"],
                _prepare_chain(
                    structures, hit["pdb_id"], hit["pdb_chain"],
                    atom_filter,
                    sifts_result.mapping[hit["mapping_index"]],
                    model,
                ),
            )
            for _, hit in entry_hits.iterrows()
        ]

        for (idx_i, ch_i), (idx_j, ch_j) in combinations(chains, 2):
            if not (len(ch_i.residues) and len(ch_j.residues)):
                continue

            distmap = DistanceMap.from_coords(ch_i, ch_j, device=device)
            distmap.id = "{}_{}".format(idx_i, idx_j)

            # symmetrize: a pair is a contact if close in either
            # orientation
            flipped = distmap.transpose()
            flipped.id = distmap.id + "_T"

            both_ways = DistanceMap.aggregate(
                distmap, flipped, intersect=intersect
            )
            both_ways.symmetric = True

            running.add(
                both_ways,
                sifts_table_index_i=idx_i,
                sifts_table_index_j=idx_j,
            )

    return running.result()


def inter_dists(sifts_result_i, sifts_result_j, structures=None,
                atom_filter=None, intersect=False, output_prefix=None,
                model=0, raise_missing=True, device=None):
    """Aggregated inter-chain distance map between two entities, over
    all chain combinations sharing a PDB id."""
    _require_hits(sifts_result_i, sifts_result_j)
    structures = _prepare_structures(
        structures,
        set(sifts_result_i.hits.pdb_id)
        | set(sifts_result_j.hits.pdb_id),
        raise_missing,
    )

    def _chains_by_hit(sifts_result):
        return {
            idx: _prepare_chain(
                structures, hit["pdb_id"], hit["pdb_chain"],
                atom_filter,
                sifts_result.mapping[hit["mapping_index"]],
                model,
            )
            for idx, hit in _usable_hits(
                sifts_result.hits, structures, raise_missing
            )
        }

    chains_i = _chains_by_hit(sifts_result_i)
    chains_j = _chains_by_hit(sifts_result_j)

    running = _RunningAggregate(intersect, output_prefix)

    for _, pair in _paired_hits(sifts_result_i,
                                sifts_result_j).iterrows():
        if not raise_missing and pair["pdb_id"] not in structures:
            continue

        idx_i, idx_j = pair["index_i"], pair["index_j"]
        ch_i, ch_j = chains_i[idx_i], chains_j[idx_j]
        if not (len(ch_i.residues) and len(ch_j.residues)):
            continue

        distmap = DistanceMap.from_coords(ch_i, ch_j, device=device)
        distmap.id = "{}_{}".format(idx_i, idx_j)

        running.add(
            distmap,
            sifts_table_index_i=idx_i,
            sifts_table_index_j=idx_j,
        )

    return running.result()


def _stringify_keys(sequence):
    """Structure residue ids are strings; align a {position: aa}
    mapping to that convention (None passes through)."""
    if sequence is None:
        return None
    return {str(k): v for k, v in sequence.items()}


def _remap_sequence(chain, sequence):
    """Rename chain residues to the target sequence (one- and
    three-letter codes); unmapped residues are dropped."""
    chain = deepcopy(chain)
    one_letter = chain.residues.id.map(sequence)
    chain.residues = chain.residues.assign(
        one_letter_code=one_letter,
        three_letter_code=one_letter.map(AA1_to_AA3),
    ).dropna(subset=["one_letter_code", "three_letter_code"])
    return chain


def remap_chains(sifts_result, output_prefix, sequence=None,
                 structures=None, atom_filter=("N", "CA", "C", "O"),
                 model=0, chain_name="A", raise_missing=True):
    """Write all structure hits as PDB files renumbered (and optionally
    re-labeled) to the target sequence. Returns {hit index: path}."""
    structures = _prepare_structures(
        structures, sifts_result.hits.pdb_id, raise_missing
    )

    if output_prefix is not None:
        create_prefix_folders(output_prefix)

    sequence = _stringify_keys(sequence)
    remapped = {}

    for idx, hit in _usable_hits(sifts_result.hits, structures,
                                 raise_missing):
        chain = _prepare_chain(
            structures, hit["pdb_id"], hit["pdb_chain"],
            atom_filter, sifts_result.mapping[hit["mapping_index"]],
            model,
        )
        if sequence is not None:
            chain = _remap_sequence(chain, sequence)

        filename = "{}_{}_{}_{}.pdb".format(
            output_prefix, hit["pdb_id"], hit["pdb_chain"],
            hit["mapping_index"],
        )
        with open(filename, "w") as f:
            chain.to_file(f, chain_id=chain_name, first_atom_id=1)

        remapped[int(idx)] = filename

    return remapped


def remap_complex_chains(sifts_result_i, sifts_result_j,
                         sequence_i=None, sequence_j=None,
                         structures=None,
                         atom_filter=("N", "CA", "C", "O"),
                         output_prefix=None, raise_missing=True,
                         chain_name_i="A", chain_name_j="B", model=0):
    """Write chain pairs from shared structures as two-chain PDB files
    renumbered to their respective target sequences."""
    sequence_i = _stringify_keys(sequence_i)
    sequence_j = _stringify_keys(sequence_j)

    if output_prefix is not None:
        create_prefix_folders(output_prefix)

    pairs = _paired_hits(sifts_result_i, sifts_result_j)
    structures = _prepare_structures(
        structures, pairs.pdb_id, raise_missing
    )

    remapped = {}

    for k, pair in pairs.iterrows():
        # tolerant loading (raise_missing=False) may have dropped
        # this structure entirely — skip it like every sibling
        # (intra/multimer/inter_dists, remap_chains) does
        if not raise_missing and pair["pdb_id"] not in structures:
            continue

        halves = []
        for side, sequence, result in (
            ("i", sequence_i, sifts_result_i),
            ("j", sequence_j, sifts_result_j),
        ):
            chain = _prepare_chain(
                structures, pair["pdb_id"],
                pair["pdb_chain_" + side],
                atom_filter,
                result.mapping[pair["mapping_index_" + side]],
                model,
            )
            if sequence is not None:
                chain = _remap_sequence(chain, sequence)
            halves.append(chain)

        chain_i, chain_j = halves

        filename = "{}_{}_{}_{}_{}_{}.pdb".format(
            output_prefix, pair["pdb_id"],
            pair["pdb_chain_i"], pair["mapping_index_i"],
            pair["pdb_chain_j"], pair["mapping_index_j"],
        )
        with open(filename, "w") as f:
            chain_i.to_file(
                f, chain_id=chain_name_i, first_atom_id=1, end=False
            )
            chain_j.to_file(
                f, chain_id=chain_name_j,
                first_atom_id=len(chain_i.coords) + 1,
            )

        remapped[int(k)] = filename

    return remapped
