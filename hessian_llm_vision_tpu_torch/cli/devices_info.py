"""Device diagnostics (port of ``cli/devices_info.py``): the devices this
process sees, with their memory in use, limit and peak, through
``torch.cuda``.

Each row has the JAX CLI's keys: ``id``, ``platform`` ("gpu", as JAX names
a CUDA device), ``kind`` (the device name), ``process`` (0),
``bytes_in_use`` (``memory_allocated``), ``bytes_limit`` (the device's
total memory) and ``peak_bytes_in_use`` (``max_memory_allocated``).
``--cpu`` lists the CPU as one row; without ``--cpu`` and without a card
it exits with an error.

  python -m hessian_llm_vision_tpu_torch.cli.devices_info [--cpu] [--json]
"""

from __future__ import annotations

import argparse
import json

import torch

from hessian_llm_vision_tpu_torch.cli.common import device_for


def device_rows(cpu: bool) -> list[dict]:
    """One row per CUDA device, or the CPU's one row with ``cpu``."""
    if device_for(cpu).type == "cpu":
        return [{"id": 0, "platform": "cpu", "kind": "cpu",
                 "process": 0}]
    rows = []
    for i in range(torch.cuda.device_count()):
        rows.append({"id": i, "platform": "gpu", "kind": torch.cuda.get_device_name(i),
                     "process": 0,
                     "bytes_in_use": torch.cuda.memory_allocated(i),
                     "bytes_limit": torch.cuda.get_device_properties(i).total_memory,
                     "peak_bytes_in_use": torch.cuda.max_memory_allocated(i)})
    return rows


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)
    rows = device_rows(args.cpu)
    if args.json:
        print(json.dumps(rows, indent=2))
    else:
        backend = "cpu" if args.cpu else "gpu"
        print(f"backend: {backend}  devices: {len(rows)}  processes: 1")
        for r in rows:
            mem = ""
            if "bytes_in_use" in r:
                mem = (f"  mem {r['bytes_in_use'] / 2**30:.2f}/"
                       f"{r.get('bytes_limit', 0) / 2**30:.2f} GiB")
            print(f"  [{r['id']}] {r['kind']} (process {r['process']}){mem}")
    return rows


if __name__ == "__main__":
    main()
