#!/usr/bin/env python
"""Print the host and CUDA card inventory (``tnn_tpu.cli.hardware_info``):
the CPU's topology (sockets, cores, P / E cores, caches, clocks), the IO
cpu set the loaders' threads pin to (``utils.affinity``), the process's
resident memory, and each card's name, memory, SM count, compute
capability, power limit (``nvidia-smi``) and the allocator's current use.

    python -m tnn_tpu_torch.cli.hardware_info [--json]
"""
from __future__ import annotations

import argparse
import json

from tnn_tpu_torch.cli import console_entry
from tnn_tpu_torch.utils import affinity
from tnn_tpu_torch.utils.hardware import (cpu_topology, device_info,
                                          device_memory_stats,
                                          memory_usage_kb)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--json", action="store_true")
    args = ap.parse_args(argv)
    info = {"cpu": cpu_topology(), "io_cpu_set": affinity.io_cpu_set(),
            "process_rss_kb": memory_usage_kb(), "devices": device_info()}
    for d in info["devices"]:
        d["memory"] = device_memory_stats(f"cuda:{d['id']}")
    if args.json:
        print(json.dumps(info, indent=2))
        return info
    cpu = info["cpu"]
    print(f"CPU: {cpu.get('model', '?')} - {cpu['logical_cores']} logical"
          + (f" / {cpu['physical_cores']} physical"
             if "physical_cores" in cpu else ""))
    print(f"  P-cores: {cpu['p_cores']}  E-cores: {cpu['e_cores']}  "
          f"IO cpu set: {info['io_cpu_set']}")
    for c in cpu.get("caches", []):
        print(f"  L{c.get('level', '?')} {c.get('type', ''):12s} "
              f"{c.get('size', '?')}")
    if "freq_khz" in cpu:
        f = cpu["freq_khz"]
        print(f"  freq: {f['min'] / 1e3:.0f}-{f['max'] / 1e3:.0f} MHz")
    if "mem_total_kb" in cpu:
        print(f"  RAM: {cpu['mem_total_kb'] / 1048576:.1f} GiB "
              f"(process RSS {info['process_rss_kb'] / 1024:.0f} MiB)")
    if not info["devices"]:
        print("no CUDA device")
    for d in info["devices"]:
        print(f"device {d['id']}: {d['kind']} (sm_{d['compute_capability']}"
              f", {d['sm_count']} SMs) - {d['memory_bytes'] / 1e9:.1f} GB, "
              f"{d['memory'].get('bytes_in_use', 0) / 1e9:.2f} GB in use, "
              f"power limit {d['power_limit'] or '?'}")
    return info


cli = console_entry(main)


if __name__ == "__main__":
    main()
