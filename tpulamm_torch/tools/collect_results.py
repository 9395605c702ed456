"""Turn perf_results.jsonl into the report's markdown tables (counterpart
of tpulamm.tools.collect_results; text only, no device).

Parity with the reference's test/collect_results.py (which scrapes the
harness's JSON log lines into the README tables, incl. --compare mode).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict


def load(path: str) -> list[dict]:
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if line:
                rows.append(json.loads(line))
    return rows


def table(rows: list[dict], keys: list[str], metric_cols: list[str]) -> str:
    hdr = "| " + " | ".join(keys + metric_cols) + " |"
    sep = "|" + "|".join("---" for _ in keys + metric_cols) + "|"
    out = [hdr, sep]
    for r in rows:
        cells = [str(r.get(k, "")) for k in keys]
        cells += [f"{r.get(c, ''):.2f}" if isinstance(r.get(c), float)
                  else str(r.get(c, "")) for c in metric_cols]
        out.append("| " + " | ".join(cells) + " |")
    return "\n".join(out)


def main(argv=None):
    p = argparse.ArgumentParser(prog="tpulamm-torch-collect-results")
    p.add_argument("log", nargs="?", default="perf_results.jsonl")
    p.add_argument("--compare", default=None,
                   help="second log to diff against (ratio column)")
    args = p.parse_args(argv)

    rows = load(args.log)
    by_test = defaultdict(list)
    for r in rows:
        by_test[r.get("test", "?")].append(r)

    cmp_map = {}
    if args.compare:
        for r in load(args.compare):
            cmp_map[(r.get("test"), r.get("dtype"))] = r

    if "matmult" in by_test:
        print("## matmul performance (GFLOPS)\n")
        mrows = by_test["matmult"]
        if cmp_map:
            for r in mrows:
                o = cmp_map.get(("matmult", r["dtype"]))
                r["vs_compare"] = (round(r["gflops"] / o["gflops"], 2)
                                   if o and o.get("gflops") else "")
            print(table(mrows, ["dtype", "device"],
                        ["gflops", "vs_compare"]))
        else:
            print(table(mrows, ["dtype", "device"], ["gflops"]))
        print()
    if "inference" in by_test:
        print("## inference performance (tokens/s)\n")
        irows = by_test["inference"]
        if cmp_map:
            for r in irows:
                o = cmp_map.get(("inference", r["dtype"]))
                r["vs_compare"] = (round(r["gen_tps"] / o["gen_tps"], 2)
                                   if o and o.get("gen_tps") else "")
            print(table(irows, ["dtype", "device"],
                        ["prompt_tps", "gen_tps", "vs_compare"]))
        else:
            print(table(irows, ["dtype", "device"],
                        ["prompt_tps", "gen_tps"]))
    return 0


if __name__ == "__main__":
    sys.exit(main())
