"""Package entry: ``python -m hessian_llm_vision_tpu_torch <command> [flags...]``.

Dispatches to the CLI modules, with the JAX package's commands.
"""

from __future__ import annotations

import importlib
import sys

COMMANDS = {
    "train": ("hessian_llm_vision_tpu_torch.cli.train",
              "train a model (sgd/adam/raw/lanczos*/gn/ngd)"),
    "spectrum": ("hessian_llm_vision_tpu_torch.cli.spectrum",
                 "Hessian/GGN/Fisher spectrum of a model or checkpoint"),
    "evaluate": ("hessian_llm_vision_tpu_torch.cli.evaluate",
                 "per-batch loss sweep of a checkpoint"),
    "forget": ("hessian_llm_vision_tpu_torch.cli.forget",
               "eigenbasis-projection forgetting experiment"),
    "sweep": ("hessian_llm_vision_tpu_torch.cli.sweep", "in-process grid sweep"),
    "hpo": ("hessian_llm_vision_tpu_torch.cli.hpo",
            "hyperparameter optimisation (optuna or random search)"),
    "devices-info": ("hessian_llm_vision_tpu_torch.cli.devices_info",
                     "device/memory diagnostics"),
}


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not argv or argv[0] in ("-h", "--help"):
        print(__doc__)
        print("commands:")
        for name, (_, desc) in COMMANDS.items():
            print(f"  {name:13s} {desc}")
        print("\nper-command help: python -m hessian_llm_vision_tpu_torch <command> --help")
        return 0
    cmd, rest = argv[0], argv[1:]
    if cmd not in COMMANDS:
        print(f"unknown command {cmd!r}; one of: {', '.join(COMMANDS)}", file=sys.stderr)
        return 2
    importlib.import_module(COMMANDS[cmd][0]).main(rest)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
