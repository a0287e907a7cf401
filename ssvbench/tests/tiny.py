"""Tiny cells for the CPU tests: the real cells' files, shrunk, and an
amino cell built in memory (no configuration or traffic file, no entry in
``BENCHMARK.json``)."""

import copy
import json
import os

from ssvbench.run import ROOT, Cell, load_cell


def tiny_cell(name: str = "rfam150k.contigs-stream", positions: int = 1_200):
    cell = load_cell(name)
    cell = copy.deepcopy(cell)
    cell.config["collection"]["model_positions"] = positions
    rec = cell.traffic["records"]
    if rec["kind"] == "bins":
        cell.traffic["files"] = 4
        rec.update(source_length=200_000, bin_length=[20_000, 60_000])
        rec["contig_length"].update(median=5_000, clip=[2_500, 20_000])
        cell.traffic["sample"].update(files=4, window=4_096, windows_per_file=4)
    else:
        rec["length"] = 30_000
        cell.traffic["sample"].update(window=4_096, windows_per_file=3)
    return cell


def tiny_amino_cell(positions: int = 1_500, isolate: bool = True,
                    files: int = 4) -> Cell:
    """Protein models (log-normal lengths, HMMER3's amino background)
    against proteomes with planted domains, searched with isolated
    models where ``isolate``; it reports the end-to-end metrics that every
    cell of ``BENCHMARK.json`` reports, and every per-layer metric."""
    config = {
        "name": "tiny-amino",
        "collection": {
            "seed": 35, "alphabet": "amino", "repeat_model_share": 0,
            "model_positions": positions,
            "model_length": {"median": 60, "sigma": 0.6, "clip": [8, 240]},
            "match_probability": 0.6, "msv_mu": -9.8664,
            "msv_lambda": 0.71313},
        "search": {"p_value": 0.02, "strand": "forward",
                   "isolate_models": isolate},
    }
    traffic = {
        "name": "tiny-proteomes", "files": files,
        "records": {"kind": "proteome", "proteins": [30, 60],
                    "protein_length": {"median": 250, "sigma": 0.6,
                                       "clip": [30, 2_000]},
                    "domain_share": 0.4, "domains": [1, 3]},
        "sample": {"files": files, "windows_per_file": 2, "window": 2_048},
    }
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    return Cell("tiny-amino.tiny-proteomes", config, traffic,
                [m for m in bench["end_to_end"] if "workloads" not in m],
                bench["per_layer"])
