#!/usr/bin/env python3
"""Spreads of a cell's runs, for setting the bounds (PERF.md, section 2).

    python3 perfbench/spread.py RESULT_FILE ...

Each file holds the stdout of one run of ``run.py``, named
``<cell>__<set>__<seed>.out``; the last line is its result.  For
every cell, set and metric it prints the median and the spread: the
distance between the first and third quartiles that
``statistics.quantiles(values, n=4)`` gives, as a share of the median.
"""

import json
import os
import statistics
import sys
from collections import defaultdict


def spread(values):
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def main(paths) -> int:
    runs = defaultdict(lambda: defaultdict(list))
    for path in paths:
        cell, group, _ = os.path.basename(path).rsplit(".", 1)[0].split("__")
        with open(path) as fh:
            lines = fh.read().strip().splitlines()
        try:
            result = json.loads(lines[-1])
        except (IndexError, ValueError):
            print(f"{path}: no result line")
            continue
        for name, m in result["metrics"].items():
            runs[(cell, name)][group].append(m["value"])
        runs[(cell, "correct")][group].append(float(result["correct"]))
    for (cell, name), groups in sorted(runs.items()):
        for group, values in sorted(groups.items()):
            line = (f"{cell} {name} set {group}: n={len(values)} "
                    f"median {statistics.median(values)!r}")
            if len(values) >= 2 and name != "correct":
                line += f" spread {spread(values):.5f}"
            print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
