"""
Index mapping for complexes / multi-domain sequences into internal
CouplingsModel numbering (port of evcouplings_tpu/couplings/mapping.py):
Segment, SegmentIndexMapper, segment_map_ecs, MultiSegmentCouplingsModel.
"""

from collections.abc import Iterable
from copy import deepcopy

import numpy as np

from evcouplings_torch.couplings.model import CouplingsModel


class Segment:
    """A continuous stretch of sequence in an alignment (a domain, or one
    monomer of a concatenated complex alignment)."""

    # config list-representation field order ([segment_id, type, id,
    # start, end, positions])
    _LIST_FIELDS = ("segment_id", "segment_type", "sequence_id",
                    "region_start", "region_end", "positions")

    def __init__(self, segment_type, sequence_id, region_start, region_end,
                 positions=None, segment_id="A"):
        self.segment_type = segment_type
        self.sequence_id = sequence_id
        self.region_start = region_start
        self.region_end = region_end
        self.positions = (
            None if positions is None else [int(p) for p in positions]
        )
        self.segment_id = segment_id

    @classmethod
    def from_list(cls, segment):
        """Create from list representation [segment_id, segment_type,
        sequence_id, region_start, region_end, positions] (config format).

        Any other arity is a malformed config list and raises ValueError
        (zip would silently truncate or pad, turning e.g. a missing
        region bound into positions=None).
        """
        if len(segment) != len(cls._LIST_FIELDS):
            raise ValueError(
                "Invalid segment list %r: expected %d elements %r"
                % (segment, len(cls._LIST_FIELDS), cls._LIST_FIELDS)
            )
        return cls(**dict(zip(cls._LIST_FIELDS, segment)))

    def to_list(self):
        """List representation for storing in configs."""
        return [getattr(self, field) for field in self._LIST_FIELDS]

    def default_chain_name(self):
        """Default PDB chain identifier (part of segment_id before "_")."""
        return self.segment_id.partition("_")[0]

    def model_positions(self, focus_mode):
        """The position labels this segment contributes to the model:
        the continuous region range in focus mode, the explicit
        (possibly discontinuous) position list otherwise."""
        if focus_mode:
            return range(self.region_start, self.region_end + 1)
        return self.positions


class SegmentIndexMapper:
    """Map per-segment indices into continuous model numbering and back."""

    def __init__(self, focus_mode, first_index, *segments):
        self.segments = deepcopy(segments)

        # target side: (segment_id, position) labels, concatenated in
        # segment order; model side: continuous ints from first_index.
        # (Some model positions may not exist in a fitted model if they
        # correspond to lowercase alignment columns.)
        self.target_pos = [
            (seg.segment_id, pos)
            for seg in segments
            for pos in seg.model_positions(focus_mode)
        ]
        self.model_pos = [
            first_index + offset
            for offset in range(len(self.target_pos))
        ]

        self.target_to_model = dict(zip(self.target_pos, self.model_pos))
        self.model_to_target = dict(zip(self.model_pos, self.target_pos))

    def patch_model(self, model, inplace=True):
        """Renumber a CouplingsModel to segment-based numbering."""
        if not inplace:
            model = deepcopy(model)

        try:
            model.index_list = [
                self.model_to_target[pos] for pos in model.index_list
            ]
        except KeyError:
            raise ValueError(
                "Mapping from target to model positions does not contain "
                "all positions of internal model numbering"
            )
        return model

    @staticmethod
    def _lookup(mapping, key_or_keys):
        # a tuple is ONE (segment_id, pos) key, not a key sequence
        if isinstance(key_or_keys, Iterable) and \
                not isinstance(key_or_keys, tuple):
            return [mapping[key] for key in key_or_keys]
        return mapping[key_or_keys]

    def __call__(self, segment_id, pos):
        return self.to_model((segment_id, pos))

    def to_target(self, x):
        """Model index (int) -> target index ((segment_id, pos))."""
        return self._lookup(self.model_to_target, x)

    def to_model(self, x):
        """Target index ((segment_id, pos)) -> model index (int)."""
        return self._lookup(self.target_to_model, x)


def segment_map_ecs(ecs, mapper):
    """Map an EC table's i/j columns from model numbering to segment
    numbering, adding segment_i/segment_j columns."""
    remapped = deepcopy(ecs)

    for column in ("i", "j"):
        pairs = mapper.to_target(remapped.loc[:, column])
        segments, positions = zip(*pairs) if pairs else ((), ())
        remapped.loc[:, column] = list(positions)
        remapped.loc[:, "segment_" + column] = list(segments)

    return remapped


class MultiSegmentCouplingsModel(CouplingsModel):
    """CouplingsModel for concatenated complex alignments: renumbers the
    model with segment-based indices, and can reduce to inter-segment-only
    couplings."""

    def __init__(self, filename, *segments, precision="float32",
                 file_format="plmc_v2", **kwargs):
        super().__init__(filename, precision, file_format, **kwargs)

        if not segments:
            raise ValueError(
                "Must provide at least one segment for "
                "MultiSegmentCouplingsModel"
            )

        SegmentIndexMapper(
            True, segments[0].region_start, *segments
        ).patch_model(model=self)

    def to_inter_segment_model(self):
        """Copy of the model with h_i = 0 and only inter-segment J_ij kept
        (intra-segment couplings zeroed)."""
        # segment id per model position; a coupling survives only when
        # its two positions live on different segments
        owner = np.array([seg_id for seg_id, _ in self.index_list])
        crosses = owner[:, None] != owner[None, :]

        reduced = deepcopy(self)
        reduced.h_i = np.zeros((self.L, self.num_symbols))
        reduced.J_ij = np.where(
            crosses[:, :, None, None], self.J_ij, 0.0
        )
        reduced._reset_precomputed()
        return reduced
