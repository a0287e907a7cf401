"""Tiny cells for the CPU tests: the real cells' files, shrunk."""

import copy

from ssvbench.run import load_cell


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
