"""
PDB structure handling (port of evcouplings_tpu/compare/pdb.py; host
pandas/numpy, no device work): BinaryCIF parsing, chain extraction,
residue / coordinate tables, classic PDB text support.

BinaryCIF columns are decoded by compare/bcif.py; the container is read
with msgpack, imported on use. ClassicPDB parses fixed-column PDB text
and needs nothing beyond pandas. load_structures accepts .bcif, .bcif.gz
and .pdb files in structure_dir and fetches an id without a local file
from the RCSB servers.
"""

import gzip
from collections import defaultdict
from collections.abc import Iterable
from os import path

import numpy as np
import pandas as pd

from evcouplings_torch.compare.bcif import decode_column
from evcouplings_torch.utils.config import InvalidParameterError
from evcouplings_torch.utils.constants import AA3_to_AA1
from evcouplings_torch.utils.system import (
    ResourceError,
    get,
    valid_file,
)

PDB_BCIF_DOWNLOAD_URL = "https://models.rcsb.org/{pdb_id}.bcif.gz"

# DSSP secondary-structure codes as emitted by MMTF/BinaryCIF-style
# integer encodings (reference compare/pdb.py:32-42)
MMTF_DSSP_CODE_MAP = {
    0: "I",   # pi helix
    1: "S",   # bend
    2: "H",   # alpha helix
    3: "E",   # extended
    4: "G",   # 3-10 helix
    5: "B",   # bridge
    6: "T",   # turn
    7: "C",   # coil
    -1: "",   # undefined
}

# Reduction of DSSP 8-state secondary structure to 3 states
DSSP_3_STATE_MAP = {
    "H": "H", "G": "H", "I": "H",
    "E": "E", "B": "E",
    "C": "C", "T": "C", "S": "C",
}

def _seqres_id_str(value):
    """Canonical string form of a label_seq_id value: masked (NaN) or
    0 / "." / "?" entries become NA, numeric entries become their
    plain integer string regardless of whether the decoded column came
    back int or (mask-promoted) float."""
    if pd.isna(value):
        return pd.NA
    try:
        as_int = int(value)
    except (TypeError, ValueError):
        s = str(value)
        return pd.NA if s in ("", ".", "?") else s
    return pd.NA if as_int == 0 else str(as_int)


# format string for PDB ATOM records
PDB_FORMAT = (
    "{atom:<6s}{atom_id:>5} "
    "{atom_name:4s}{alt_loc_ind:1s}{residue_name:<3s} "
    "{chain_id:1s}{residue_id:>4}{ins_code:1}   "
    "{x_coord:>8.3f}{y_coord:>8.3f}{z_coord:>8.3f}"
    "{occupancy:>6.2f}{temp_factor:>6.2f}          "
    "{element_symbol:>2}{charge:>2}"
)


class Chain:
    """Container for one PDB chain: residue table + atom coordinates."""

    def __init__(self, residues, coords):
        self.residues = residues
        self.coords = coords

    def _update_ids(self, ids):
        """Assign new residue ids; residues without a new id (NaN) are
        dropped together with their atoms."""
        residues = self.residues.copy()
        residues.loc[:, "id"] = ids.copy()
        residues = residues.dropna(subset=["id"])

        coords = self.coords.loc[
            self.coords.residue_index.isin(residues.index)
        ].reset_index(drop=True)

        return Chain(residues, coords)

    def to_seqres(self):
        """Copy of chain re-indexed by SEQRES numbering (residues
        without one are dropped)."""
        return self._update_ids(self.residues.loc[:, "seqres_id"])

    def filter_atoms(self, atom_name="CA"):
        """Keep only the named atom(s) (and residues that have them)."""
        if isinstance(atom_name, str):
            sel = self.coords.atom_name == atom_name
        else:
            sel = self.coords.atom_name.isin(atom_name)

        coords = self.coords.loc[sel].reset_index(drop=True)
        residues = self.residues.loc[
            self.residues.index.isin(coords.residue_index)
        ].copy()
        return Chain(residues, coords)

    def filter_positions(self, positions):
        """Keep only the given residue ids."""
        positions = [str(p) for p in positions]

        residues = self.residues.loc[
            self.residues.id.isin(positions)
        ].copy()
        coords = self.coords.loc[
            self.coords.residue_index.isin(residues.index)
        ].reset_index(drop=True)
        return Chain(residues, coords)

    def remap(self, mapping, source_id="seqres_id"):
        """Renumber residues via a mapping of individual ids
        (str -> str) or inclusive index ranges
        ((start, end) -> (start, end))."""
        test_key = next(iter(mapping.keys()))

        if isinstance(test_key, Iterable) and not isinstance(test_key, str):
            final_mapping = {}
            for (src_start, src_end), (tgt_start, tgt_end) in \
                    mapping.items():
                source = map(str, range(src_start, src_end + 1))
                target = map(str, range(tgt_start, tgt_end + 1))
                final_mapping.update(dict(zip(source, target)))
        else:
            final_mapping = {
                str(s): str(t) for (s, t) in mapping.items()
            }

        ids = self.residues.loc[:, source_id].map(
            final_mapping, na_action="ignore"
        )
        return self._update_ids(ids)

    def to_file(self, fileobj, chain_id="A", end=True, first_atom_id=1):
        """Write the chain as fixed-column PDB ATOM records."""
        OLD_PDB_MAX_ATOM_NUM = 99999
        OLD_PDB_MAX_RESIDUE_NUM = 9999

        x = self.coords.merge(
            self.residues, left_on="residue_index", right_index=True
        )

        if first_atom_id is not None:
            if first_atom_id < 1:
                raise ValueError("First atom index must be > 0")
            x = x.assign(atom_id=np.arange(
                first_atom_id, first_atom_id + len(x)
            ))

        for _, r in x.iterrows():
            cid = str(r["id"])
            if cid[-1].isalpha():
                coord_id, ins_code = cid[:-1], cid[-1]
            else:
                coord_id, ins_code = cid, ""

            if int(coord_id) > OLD_PDB_MAX_RESIDUE_NUM:
                raise ValueError(
                    "Residue index is too wide for old PDB format: "
                    "{} (maximum is {})".format(
                        coord_id, OLD_PDB_MAX_RESIDUE_NUM
                    )
                )
            if int(r["atom_id"]) > OLD_PDB_MAX_ATOM_NUM:
                raise ValueError(
                    "Atom index is too wide for old PDB format: "
                    "{} (maximum is {})".format(
                        r["atom_id"], OLD_PDB_MAX_ATOM_NUM
                    )
                )

            element = str(r["element"]).upper()

            # 4-column atom name: 2 right-justified element chars then
            # 2 left-justified specifier chars (except 4-char names)
            src_atom_name = r["atom_name"]
            if len(src_atom_name) == 4:
                atom_name = src_atom_name
            else:
                atom_element = src_atom_name[0:len(element)]
                atom_spec = src_atom_name[len(element):]
                atom_name = "{:>2s}{:<2s}".format(atom_element, atom_spec)

            charge = r["charge"]
            if isinstance(charge, (int, np.integer)) and charge != 0:
                charge_str = "{}{}".format(
                    abs(charge), "-" if charge < 0 else "+"
                )
            else:
                charge_str = ""

            fileobj.write(PDB_FORMAT.format(
                atom="HETATM" if r["hetatm"] else "ATOM",
                atom_id=r["atom_id"], atom_name=atom_name,
                alt_loc_ind=str(r.get("alt_loc", "") or ""),
                residue_name=r["three_letter_code"], chain_id=chain_id,
                residue_id=coord_id, ins_code=ins_code,
                x_coord=r["x"], y_coord=r["y"], z_coord=r["z"],
                occupancy=r["occupancy"], temp_factor=r["b_factor"],
                element_symbol=element, charge=charge_str,
            ) + "\n")

        if end:
            fileobj.write("END" + 77 * " " + "\n")


def _select_rename(df, spec):
    """Project df onto spec's source columns (order-preserving);
    tuple entries (source, target) rename, bare names keep
    themselves."""
    pairs = [(s, s) if isinstance(s, str) else s for s in spec]
    return df.loc[:, [src for src, _ in pairs]].rename(
        columns=dict(pairs)
    )


def _bcif_columns(category, fields):
    """{bcif column name: our column name} for one mmCIF category;
    a bare field name keeps itself as the target name."""
    out = {}
    for field in fields:
        if isinstance(field, tuple):
            source, target = field
        else:
            source = target = field
        out[category + "." + source] = target
    return out


# BinaryCIF _atom_site columns used by PDB.get_chain
_ATOM_TARGET_COLS = _bcif_columns("_atom_site", (
    ("pdbx_PDB_model_num", "model_number"),
    ("group_PDB", "record_type"),
    "id",
    "type_symbol",
    "label_atom_id",
    "auth_atom_id",
    "label_alt_id",
    "label_comp_id",
    "auth_comp_id",
    "label_asym_id",
    "auth_asym_id",
    "label_entity_id",
    "label_seq_id",
    "auth_seq_id",
    ("pdbx_PDB_ins_code", "insertion_code"),
    ("Cartn_x", "x"),
    ("Cartn_y", "y"),
    ("Cartn_z", "z"),
    "occupancy",
    ("B_iso_or_equiv", "b_factor"),
    ("pdbx_formal_charge", "charge"),
))

# helix/sheet secondary-structure ranges share their field layout
_SSE_RANGE_FIELDS = (
    "id",
    "beg_label_asym_id",
    "beg_label_seq_id",
    "end_label_asym_id",
    "end_label_seq_id",
)

_CONF_TARGET_COLS = _bcif_columns(
    "_struct_conf",
    (("conf_type_id", "conformation_type"),) + _SSE_RANGE_FIELDS,
)

_SHEET_TARGET_COLS = _bcif_columns(
    "_struct_sheet_range", ("sheet_id",) + _SSE_RANGE_FIELDS,
)


class PDB:
    """Structure parsed from BinaryCIF (successor of the MMTF path)."""

    def __init__(self, filehandle, keep_full_data=False):
        import msgpack

        try:
            raw_data = msgpack.unpack(filehandle, use_list=True)
        except Exception as e:
            raise ResourceError(
                "Could not parse BinaryCIF data (invalid or truncated "
                "file): {}".format(e)
            ) from e

        def _key(x):
            return x.decode() if isinstance(x, bytes) else x

        data = {
            "{}.{}".format(_key(category["name"]), _key(column["name"])):
                column
            for block in raw_data["dataBlocks"]
            for category in block["categories"]
            for column in category["columns"]
        }

        self.data = data if keep_full_data else None

        self.atom_table = pd.DataFrame({
            name: decode_column(data[source_column])
            for source_column, name in _ATOM_TARGET_COLS.items()
        }).assign(
            # chain identifiers must be strings (some entries store ints)
            auth_asym_id=lambda df: df.auth_asym_id.astype(str),
            label_asym_id=lambda df: df.label_asym_id.astype(str),
        )

        # helix/strand tables may be absent entirely
        try:
            self.conf_table = pd.DataFrame({
                name: decode_column(data[source_column])
                for source_column, name in _CONF_TARGET_COLS.items()
            }).query(
                # drop (incorrect) assignments spanning several chains
                "beg_label_asym_id == end_label_asym_id"
            )
        except KeyError:
            self.conf_table = None

        try:
            self.sheet_table = pd.DataFrame({
                name: decode_column(data[source_column])
                for source_column, name in _SHEET_TARGET_COLS.items()
            })
        except KeyError:
            self.sheet_table = None

        # expand secondary-structure segments into per-residue rows
        sse_raw = []
        for sse_type, sse_table, sse_filter in [
            ("H", self.conf_table, "HELX"),
            ("E", self.sheet_table, None),
            ("E", self.conf_table, "STRN"),
        ]:
            if sse_table is None:
                continue
            if sse_filter is not None:
                sse_table = sse_table.query(
                    "conformation_type.str.startswith('{}')".format(
                        sse_filter
                    )
                )
            for _, row in sse_table.iterrows():
                for seq_id in range(
                    int(row.beg_label_seq_id), int(row.end_label_seq_id) + 1
                ):
                    sse_raw.append({
                        "label_asym_id": row.beg_label_asym_id,
                        "label_seq_id": seq_id,
                        "sec_struct_3state": sse_type,
                    })

        if len(sse_raw) > 0:
            # segments can overlap; first assignment wins
            self.secondary_structure = pd.DataFrame(
                sse_raw
            ).drop_duplicates(subset=["label_asym_id", "label_seq_id"])
        else:
            self.secondary_structure = None

        self.models = list(sorted(self.atom_table.model_number.unique()))

        self.model_to_chains = self.atom_table[
            ["model_number", "auth_asym_id"]
        ].drop_duplicates().groupby("model_number").agg(
            lambda s: list(s)
        )["auth_asym_id"].to_dict()

        self.model_to_asym_ids = self.atom_table[
            ["model_number", "label_asym_id"]
        ].drop_duplicates().groupby("model_number").agg(
            lambda s: list(s)
        )["label_asym_id"].to_dict()

    @classmethod
    def from_file(cls, filename, keep_full_data=False):
        """Load a .bcif or .bcif.gz file."""
        try:
            opener = (
                gzip.open if filename.lower().endswith(".gz") else open
            )
            with opener(filename, mode="rb") as f:
                return cls(f, keep_full_data=keep_full_data)
        except IOError as e:
            raise ResourceError(
                "Could not open file {}".format(filename)
            ) from e

    @classmethod
    def from_id(cls, pdb_id, keep_full_data=False):
        """Fetch a structure from the RCSB modelserver by PDB id."""
        from io import BytesIO

        try:
            r = get(
                PDB_BCIF_DOWNLOAD_URL.format(pdb_id=pdb_id.lower()),
                allow_redirects=True,
            )
        except Exception as e:
            raise ResourceError(
                "Error fetching bCIF data for {}".format(pdb_id)
            ) from e

        with gzip.GzipFile(fileobj=BytesIO(r.content), mode="r") as f:
            return cls(f, keep_full_data=keep_full_data)

    def get_chain(self, chain, model=0, is_author_id=True):
        """Extract one chain as a Chain object.

        model is an *index* into self.models (not the PDB model id).
        """
        if not 0 <= model < len(self.models):
            raise ValueError(
                "Invalid model index, valid options: {}".format(
                    ",".join(map(str, range(len(self.models))))
                )
            )
        model_number = self.models[model]

        if ((is_author_id and chain not in
                self.model_to_chains[model_number]) or
                (not is_author_id and chain not in
                 self.model_to_asym_ids[model_number])):
            raise ValueError(
                "Invalid chain selection, check self.model_to_chains / "
                "self.model_to_asym_ids for options"
            )

        chain_field = "auth_asym_id" if is_author_id else "label_asym_id"

        atoms = self.atom_table.query(
            "model_number == @model_number and {} == @chain".format(
                chain_field
            )
        ).assign(
            # author residue id + insertion code is the unique coord id
            coord_id=lambda df: (
                df.auth_seq_id.astype(int).astype(str)
                + df.insertion_code.astype(str)
            ),
            # label_seq_id decodes as float64 with NaN when the bcif
            # column carries a mask (any HETATM/water does), so a
            # plain astype(str) would yield "1.0"-style ids that never
            # match SIFTS mapping keys — normalize through int first
            seqres_id=lambda df: df.label_seq_id.map(_seqres_id_str),
            one_letter_code=lambda df: df.label_comp_id.map(
                AA3_to_AA1, na_action="ignore"
            ),
            hetatm=lambda df: df.record_type == "HETATM",
        ).reset_index(drop=True)

        res = atoms.drop_duplicates(subset=["coord_id"]).assign(
            id=lambda df: df.coord_id
        ).reset_index(drop=True)
        res.index.name = "residue_index"

        if self.secondary_structure is not None:
            res_sse = res.merge(
                self.secondary_structure,
                on=("label_seq_id", "label_asym_id"),
                how="left",
            )
        else:
            res_sse = res.assign(sec_struct_3state=pd.NA)

        # coil is implicit (absent from helix/sheet tables)
        res_sse.loc[
            res_sse.sec_struct_3state.isnull()
            & res_sse.seqres_id.notnull(),
            "sec_struct_3state",
        ] = "C"

        res_final = _select_rename(res_sse, (
            "id", "seqres_id", "coord_id", "one_letter_code",
            ("label_comp_id", "three_letter_code"),
            ("auth_asym_id", "chain_id"),
            ("label_asym_id", "asym_id"),
            ("label_entity_id", "entity_id"),
            "sec_struct_3state", "hetatm",
        ))

        atoms_with_residue_idx = _select_rename(
            atoms.merge(
                res.reset_index()[["coord_id", "residue_index"]],
                on="coord_id",
            ),
            ("residue_index", ("id", "atom_id"),
             ("label_atom_id", "atom_name"), ("type_symbol", "element"),
             "charge", "x", "y", "z", "occupancy", "b_factor",
             ("label_alt_id", "alt_loc")),
        )
        assert len(atoms_with_residue_idx) == len(atoms)

        return Chain(res_final, atoms_with_residue_idx)


class ClassicPDB:
    """Fixed-column PDB text parser with the same Chain interface.

    Native replacement for the reference's Bio.PDB wrapper
    (pdb.py:1076-1280); cannot provide SEQRES numbering (like the
    reference).
    """

    def __init__(self, models):
        # models: {model_id: {chain_id: (residues list, atoms list)}}
        self._models = models
        self.models = list(models.keys())
        self.model_to_chains = {
            m: list(chains.keys()) for m, chains in models.items()
        }

    @classmethod
    def from_id(cls, pdb_id):
        """Fetch a classic PDB text file from RCSB by ID and parse it
        (reference pdb.py:1148-1175, which goes through Bio.PDB's
        PDBList; here a direct HTTPS fetch of the .pdb entry file).
        """
        from evcouplings_torch.utils.system import get, tempdir

        url = "https://files.rcsb.org/download/{}.pdb".format(
            pdb_id.lower()
        )
        out = path.join(tempdir(), "{}.pdb".format(pdb_id.lower()))
        try:
            get(url, output_path=out, allow_redirects=True)
        except ResourceError as e:
            raise ResourceError(
                "Could not fetch PDB data for {}".format(pdb_id)
            ) from e
        return cls.from_file(out, file_format="pdb")

    @classmethod
    def from_file(cls, filename, file_format="pdb"):
        """Parse a classic PDB text file (mmCIF not supported natively)."""
        if file_format != "pdb":
            raise InvalidParameterError(
                "Invalid file_format, valid options are: pdb"
            )

        try:
            opener = (
                gzip.open if filename.lower().endswith(".gz") else open
            )
            with opener(filename, mode="rt") as f:
                return cls(cls._parse(f))
        except FileNotFoundError as e:
            raise ResourceError(
                "Could not find file {}".format(filename)
            ) from e

    @classmethod
    def _parse(cls, fileobj):
        models = {}
        model_id = 0
        current = defaultdict(lambda: ([], []))

        for line in fileobj:
            record = line[0:6].strip()

            if record == "MODEL":
                model_id = int(line[10:14])
                continue
            if record == "ENDMDL":
                models[model_id] = dict(current)
                current = defaultdict(lambda: ([], []))
                model_id += 1
                continue
            if record not in ("ATOM", "HETATM"):
                continue

            chain_id = line[21]
            atom_id = int(line[6:11])
            atom_name = line[12:16].strip()
            alt_loc = line[16].strip()
            res_name = line[17:20].strip()
            res_seq = line[22:26].strip()
            ins_code = line[26].strip()
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            # generated/modeling PDBs commonly leave occupancy and
            # B-factor as whitespace in full-width lines; strip so
            # they parse as NaN instead of crashing float('      ')
            occupancy = float(line[54:60].strip() or "nan")
            b_factor = float(line[60:66].strip() or "nan")
            element = line[76:78].strip()

            residues, atoms = current[chain_id]
            residue_id = "{}{}".format(res_seq, ins_code)

            if not residues or residues[-1]["id"] != residue_id:
                residues.append({
                    "id": residue_id,
                    "seqres_id": np.nan,
                    "coord_id": residue_id,
                    "one_letter_code": AA3_to_AA1.get(res_name, np.nan),
                    "three_letter_code": res_name,
                    "chain_id": chain_id,
                    "sec_struct_3state": np.nan,
                    "hetatm": record == "HETATM",
                })

            atoms.append({
                "residue_index": len(residues) - 1,
                "atom_id": atom_id,
                "atom_name": atom_name,
                "element": element,
                "charge": np.nan,
                "x": x,
                "y": y,
                "z": z,
                "alt_loc": alt_loc,
                "occupancy": occupancy,
                "b_factor": b_factor,
            })

        if current:
            models[model_id] = dict(current)
        return models

    def get_chain(self, chain, model=0):
        """Extract one chain as a Chain object.

        model is an *index* into self.models — the convention every
        caller and the sibling PDB.get_chain use — NOT the raw PDB
        MODEL serial (which starts at 1 in multi-model/NMR files, so
        treating the default model=0 as a serial made every such file
        unusable)."""
        if not 0 <= model < len(self.models):
            raise ValueError(
                "Invalid model index, valid indices are: "
                + ",".join(map(str, range(len(self.models))))
            )
        model_id = self.models[model]
        if chain not in self._models[model_id]:
            raise ValueError(
                "Invalid chain, valid chains are: "
                + ",".join(self.model_to_chains[model_id])
            )

        residues, atoms = self._models[model_id][chain]
        res_df = pd.DataFrame(residues)
        res_df.index.name = "residue_index"
        res_df.loc[:, "coord_id"] = res_df.loc[:, "coord_id"].astype(str)
        coord_df = pd.DataFrame(atoms)
        return Chain(res_df, coord_df)


def load_structures(pdb_ids, structure_dir=None, raise_missing=True):
    """Load PDB structures from a local directory or the RCSB servers.

    Local files are looked up as <id>.bcif, <id>.bcif.gz or <id>.pdb
    inside structure_dir. Returns {lower-case id: PDB/ClassicPDB}.
    """
    structures = {}

    for pdb_id in set(pdb_ids):
        pdb_id = pdb_id.lower()

        structure_file = None
        loader = PDB.from_file
        if structure_dir is not None:
            for ext, ldr in [
                (".bcif", PDB.from_file),
                (".bcif.gz", PDB.from_file),
                (".pdb", ClassicPDB.from_file),
            ]:
                candidate = path.join(structure_dir, pdb_id + ext)
                if valid_file(candidate):
                    structure_file = candidate
                    loader = ldr
                    break

        try:
            if structure_file is not None:
                structures[pdb_id] = loader(structure_file)
            else:
                structures[pdb_id] = PDB.from_id(pdb_id)
        except (ResourceError, UnicodeDecodeError):
            if raise_missing:
                raise

    return structures
