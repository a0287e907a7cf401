"""Carry state and inputs from the JAX engine into the PyTorch engine.

The system has no weights; its parameters are the projected score rows and
the database tables, and its chain state is the DP row state and the carry
column. These helpers turn the JAX engine's numpy state into the port's
tensors, and the JAX package's input objects (profile HMMs, encoded
databases) into the port's own classes (:func:`profile_hmms_from_reference`,
:func:`database_from_reference`). They import nothing of JAX or of the JAX
package: objects are read by their fields, and the SWAR unpacking is
reimplemented here (`havac_tpu/ops/ssv_swar.py` `unpack_state` imports
jax). Either JAX kernel's chain state carries over: :func:`state_from_swar`
reads the SWAR kernel's, :func:`state_from_unpacked` the unpacked kernel's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np
import torch

from havac_tpu_torch.io.fasta import SequenceDatabase
from havac_tpu_torch.io.hmm import ProfileHmm

SWAR_FIELD_BITS = 10  # three 10-bit cells per int32 word
SWAR_FIELD_MASK = (1 << SWAR_FIELD_BITS) - 1


@dataclass
class EngineTensors:
    """A loaded engine's state as the port's tensors. ``scores`` are the
    raw (unbiased) int8 projected scores — never the SWAR kernel's +256
    biased, -128-padded strips."""

    scores: torch.Tensor  # int8 (P, card)
    phmm_prefix: torch.Tensor  # int64 (models + 1,)
    reset_rows: Optional[torch.Tensor]  # int32 (P,) or None
    codes: torch.Tensor  # uint8 (padded length,)
    starts: torch.Tensor  # int64 (sequences + 1,)
    lengths: torch.Tensor  # int64 (sequences,)
    alphabet: str
    strand: str


def profile_hmms_from_reference(models) -> List[ProfileHmm]:
    """The port's :class:`ProfileHmm` objects with the fields of JAX-package
    ``ProfileHmm`` objects (any objects with those fields), scores copied."""
    return [ProfileHmm(
        name=m.name, model_length=int(m.model_length),
        max_length=int(m.max_length), alphabet=m.alphabet,
        msv_mu=float(m.msv_mu), msv_lambda=float(m.msv_lambda),
        match_scores=np.array(m.match_scores, dtype=np.float32),
        accession=m.accession, description=m.description,
        extra_header_lines=list(m.extra_header_lines)) for m in models]


def database_from_reference(db) -> SequenceDatabase:
    """The port's :class:`SequenceDatabase` with the fields of a
    JAX-package ``SequenceDatabase`` (any object with those fields),
    arrays copied."""
    return SequenceDatabase(
        codes=np.array(db.codes, dtype=np.uint8),
        starts=np.array(db.starts, dtype=np.int64),
        lengths=np.array(db.lengths, dtype=np.int64),
        names=list(db.names), seed=int(db.seed),
        alphabet=getattr(db, "alphabet", "dna"))


def from_reference_engine(engine, device) -> EngineTensors:
    """The loaded state of a ``havac_tpu.engine.Havac`` on ``device``."""
    if engine.scores is None or engine.database is None:
        raise ValueError("the engine has no models or database loaded")
    dev = torch.device(device)

    def t(a, dtype):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dtype)).to(dev)

    db = engine.database
    return EngineTensors(
        scores=t(engine.scores, np.int8),
        phmm_prefix=t(engine.phmm_prefix, np.int64),
        reset_rows=(None if engine.reset_rows is None
                    else t(engine.reset_rows, np.int32)),
        codes=t(db.codes, np.uint8),
        starts=t(db.starts, np.int64),
        lengths=t(db.lengths, np.int64),
        alphabet=engine.alphabet,
        strand=engine.strand,
    )


def state_from_swar(packed: np.ndarray, device) -> torch.Tensor:
    """The SWAR kernel's packed (B, WS, 128) row state as the (B*W,) int32
    state the port chains (W = 3*WS*128). Field f of word w in block b
    holds position b*W + f*WS*128 + w."""
    packed = np.asarray(packed)
    B = packed.shape[0]
    words = packed.astype(np.int64).reshape(B, -1)
    fields = np.stack([(words >> (SWAR_FIELD_BITS * f)) & SWAR_FIELD_MASK
                       for f in range(3)], axis=1)
    return torch.from_numpy(
        fields.reshape(-1).astype(np.int32)).to(torch.device(device))


def state_from_unpacked(blocks: np.ndarray, device) -> torch.Tensor:
    """The unpacked kernel's (B, WS, 128) int32 row state (``ostate`` of
    `havac_tpu/ops/ssv_pallas.py` `_ssv_pallas_jit`) as the (B*W,) int32
    state the port chains (W = WS*128): word (b, r, c) holds position
    b*W + r*128 + c, so the state is the blocks read in order."""
    flat = np.ascontiguousarray(blocks, dtype=np.int32).reshape(-1)
    return torch.from_numpy(flat.copy()).to(torch.device(device))


def checkpoint_from_reference(path: str
                              ) -> Tuple[int, np.ndarray, np.ndarray,
                                         np.ndarray, int]:
    """Read the JAX pipelined engine's checkpoint npz: (next_ci, carries
    (n_row, rchunk+1) int32, hit_rows int64, hit_positions int64,
    fingerprint). The port writes and resumes the same form, so its engine
    continues such a run when its chunk geometry agrees."""
    with np.load(path) as ck:
        return (int(ck["next_ci"]), ck["carries"].astype(np.int32),
                ck["hit_rows"].astype(np.int64),
                ck["hit_positions"].astype(np.int64),
                int(ck["fingerprint"]))
