"""Cross-validation against nhmmer: tblout parsing + containment comparison.

The analog of the reference's hmmerValidation tool
(`test/hmmerValidation/hmmerValidation.cpp:38-132`), which runs a patched
nhmmer (early-return after `p7_SSVFilter_longtarget`) and checks hit
containment in both directions by accession + envelope ranges. We parse
nhmmer's standard ``--tblout`` table (or the SSV-window dump of the patched
build) and compute bidirectional recall:

  * every engine hit must land inside some nhmmer window for the same
    (model, sequence) pair;
  * every nhmmer window must contain at least one engine hit.

Disagreements under ~2% are expected from int8 quantization at the threshold
boundary (quantified by havac_tpu.validation.quantization, the hmmerSsvRef
analog).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterable, List, Sequence, Tuple


@dataclass(frozen=True)
class NhmmerWindow:
    """One nhmmer hit window (tblout row, `hmmerHit.cpp` fields)."""

    target_name: str  # sequence
    query_name: str  # model name
    query_accession: str  # model accession
    hmm_from: int  # 1-based inclusive, model coords
    hmm_to: int
    ali_from: int  # 1-based inclusive, sequence coords (may be reversed)
    ali_to: int
    strand: str = "+"
    score: float = 0.0
    evalue: float = 0.0

    @property
    def seq_lo(self) -> int:
        return min(self.ali_from, self.ali_to)

    @property
    def seq_hi(self) -> int:
        return max(self.ali_from, self.ali_to)


def parse_tblout(text: str) -> List[NhmmerWindow]:
    """Parse nhmmer ``--tblout`` output (one row per hit window).

    Columns (space-separated, '#' comments): target name, target accession,
    query name, query accession, hmmfrom, hmmto, alifrom, alito, envfrom,
    envto, sq len, strand, E-value, score, bias, description.
    """
    windows: List[NhmmerWindow] = []
    for line in text.splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        f = line.split()
        if len(f) < 15:
            raise ValueError(f"malformed tblout row: {line!r}")
        windows.append(NhmmerWindow(
            target_name=f[0],
            query_name=f[2],
            query_accession="" if f[3] == "-" else f[3],
            hmm_from=int(f[4]),
            hmm_to=int(f[5]),
            # env coords are the wider bound; use them for containment like
            # the reference (hmmerValidation.cpp:105-118).
            ali_from=int(f[8]),
            ali_to=int(f[9]),
            strand=f[11],
            evalue=float(f[12]),
            score=float(f[13]),
        ))
    return windows


def load_tblout(path: str) -> List[NhmmerWindow]:
    with open(path) as f:
        return parse_tblout(f.read())


@dataclass
class ContainmentReport:
    """Bidirectional recall between engine hits and nhmmer windows."""

    num_hits: int
    num_windows: int
    hits_contained: int  # engine hits inside some window
    windows_covered: int  # windows containing >= 1 engine hit
    uncontained_hits: List[Tuple[str, int, str]]  # (seq, pos, model)
    uncovered_windows: List[NhmmerWindow]

    @property
    def hit_recall(self) -> float:
        return self.hits_contained / self.num_hits if self.num_hits else 1.0

    @property
    def window_recall(self) -> float:
        return self.windows_covered / self.num_windows if self.num_windows else 1.0


def compare_containment(
    hits: Iterable[Tuple],
    windows: Sequence[NhmmerWindow],
    slack: int = 0,
    watson_only: bool = True,
) -> ContainmentReport:
    """Check containment both directions.

    ``hits``: (sequence name, 0-based sequence position, model label) triples
    or (..., strand) quadruples — model label matches window query accession
    if present else query name, like the reference's accession matching
    (`hmmerValidation.cpp:84-96`). When a hit carries a strand, it only
    matches windows of that strand (both sides use forward coordinates, so
    the interval test is unchanged).
    ``slack``: positions of tolerance at window edges.
    ``watson_only``: ignore '-' strand windows (forward-only engine runs; the
    reference benchmarks run nhmmer --watson, `benchmark/readme.txt:63`).
    """
    windows = [w for w in windows if not (watson_only and w.strand == "-")]
    by_key: Dict[Tuple[str, str, str], List[NhmmerWindow]] = {}
    for w in windows:
        label = w.query_accession or w.query_name
        by_key.setdefault((w.target_name, label, w.strand), []).append(w)

    hits = list(hits)
    covered = set()
    contained = 0
    uncontained: List[Tuple[str, int, str]] = []
    for hit in hits:
        seq, pos, model = hit[0], hit[1], hit[2]
        strands = (hit[3],) if len(hit) > 3 else ("+", "-")
        found = False
        for st in strands:
            for w in by_key.get((seq, model, st), ()):  # few windows per pair
                if w.seq_lo - 1 - slack <= pos <= w.seq_hi - 1 + slack:
                    covered.add(id(w))
                    found = True
        if found:
            contained += 1
        else:
            uncontained.append((seq, pos, model))

    uncovered = [w for w in windows if id(w) not in covered]
    return ContainmentReport(
        num_hits=len(hits),
        num_windows=len(windows),
        hits_contained=contained,
        windows_covered=len(windows) - len(uncovered),
        uncontained_hits=uncontained,
        uncovered_windows=uncovered,
    )


def engine_hits_for_comparison(engine) -> List[Tuple[str, int, str, str]]:
    """Resolved engine hits → (sequence name, position, model label, strand)
    rows; minus-strand hits (strand="both" runs) carry '-' and match only
    '-' windows in :func:`compare_containment`."""
    resolved = engine.hits()
    names = engine.database.names
    out = []
    for si, sp, mi, mp, st in resolved.as_tuples_stranded():
        model = engine.models[mi]
        out.append((names[si], sp, model.accession or model.name, st))
    return out
