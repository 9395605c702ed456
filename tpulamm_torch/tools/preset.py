"""Run the port's tools with YAML presets (counterpart of
tpulamm.tools.preset).

Capability parity with the reference's scripts/run-with-preset.py
(llama.cpp-b2430/scripts/run-with-preset.py:1-108): YAML property names are
the tool's long CLI argument names (hyphens and underscores equivalent),
flags are `name: true`, lists repeat the argument, later files override
earlier ones, and extra `--name value` args on the command line override
every preset file. The `tool` (reference: `binary`) property picks which
entry point runs: main, perplexity, bench, or server. Each runs on CUDA
unless the preset or the command line says `device: cpu` / `--device cpu`.

    python -m tpulamm_torch.tools.preset gen.yaml --n-predict 32
"""

from __future__ import annotations

import sys

TOOLS = {
    "main": "tpulamm_torch.cli.main",
    "perplexity": "tpulamm_torch.cli.perplexity",
    "bench": "tpulamm_torch.cli.bench",
    "server": "tpulamm_torch.server.server",
}


def props_to_argv(props: dict) -> list[str]:
    argv: list[str] = []
    for name, val in props.items():
        flag = "--" + name.replace("_", "-")
        if isinstance(val, bool):
            if val:
                argv.append(flag)
        elif isinstance(val, (list, tuple)):
            for item in val:
                argv += [flag, str(item)]
        else:
            argv += [flag, str(val)]
    return argv


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    import yaml

    yaml_files = []
    rest = []
    tool_override = None
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in ("-h", "--help"):
            print(__doc__)
            return 0
        if a in ("-t", "--tool", "-bin", "--binary"):
            tool_override = argv[i + 1]
            i += 2
            continue
        if not a.startswith("-") and (a.endswith(".yml")
                                      or a.endswith(".yaml")):
            yaml_files.append(a)
        else:
            rest.append(a)
        i += 1

    if not yaml_files and not rest:
        print(__doc__)
        return 0

    props: dict = {}
    for path in yaml_files:
        with open(path) as f:
            loaded = yaml.safe_load(f) or {}
        if not isinstance(loaded, dict):
            print(f"error: {path} must contain a YAML mapping",
                  file=sys.stderr)
            return 1
        props.update(loaded)
    props = {k.replace("_", "-"): v for k, v in props.items()}

    tool = str(props.pop("tool", props.pop("binary", "main")))
    if tool_override:
        tool = tool_override
    if tool not in TOOLS:
        print(f"error: unknown tool {tool!r} (choose from "
              f"{', '.join(TOOLS)})", file=sys.stderr)
        return 1

    # command-line overrides replace preset values for the same flag
    override_names = {a.lstrip("-").replace("_", "-")
                      for a in rest if a.startswith("--")}
    props = {k: v for k, v in props.items() if k not in override_names}

    tool_argv = props_to_argv(props) + rest
    print(f"preset -> {TOOLS[tool]} {' '.join(tool_argv)}", file=sys.stderr)
    import importlib
    mod = importlib.import_module(TOOLS[tool])
    return mod.main(tool_argv) or 0


if __name__ == "__main__":
    sys.exit(main())
