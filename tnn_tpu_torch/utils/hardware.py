"""Host and device readings (``tnn_tpu.utils.hardware``).

``memory_usage_kb`` is the process's resident set; ``device_memory_stats``
reads the card's allocator through ``torch.cuda.memory_stats``, where the
JAX package's ``hbm_stats`` reads the TPU's; ``cpu_info`` summarizes the
host from ``/proc`` and ``cpu_topology`` adds the sysfs report
(sockets, physical cores, P / E cores, caches, clock range), as the JAX
package's does; ``device_info`` lists the CUDA cards with their memory,
SM count, ``nvidia-smi`` power limit and the process group's
``process_index`` (``cli.hardware_info``).
``hbm_stats`` is the JAX package's name for ``device_memory_stats``.
"""
from __future__ import annotations

import os
import subprocess
from typing import Any, Dict, List

import torch


def memory_usage_kb() -> int:
    """Current process RSS in KiB (0 where ``/proc`` is not readable)."""
    try:
        with open("/proc/self/status", "r") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return int(line.split()[1])
    except OSError:
        pass
    return 0


def device_memory_stats(device=None) -> Dict[str, int]:
    """The card's memory in bytes under the JAX package's key names:
    ``bytes_in_use`` and ``peak_bytes_in_use`` (the caching allocator's
    current and peak allocated bytes) and ``bytes_limit`` (the card's
    total). Empty for a CPU device or without a card."""
    dev = torch.device(device) if device is not None else None
    if (dev is not None and dev.type != "cuda") \
            or not torch.cuda.is_available():
        return {}
    stats = torch.cuda.memory_stats(dev)
    return {"bytes_in_use": int(stats.get("allocated_bytes.all.current", 0)),
            "peak_bytes_in_use": int(stats.get("allocated_bytes.all.peak", 0)),
            "bytes_limit": int(torch.cuda.get_device_properties(
                dev if dev is not None else torch.cuda.current_device())
                .total_memory)}


def hbm_stats(device=None) -> Dict[str, int]:
    """``device_memory_stats`` under the JAX package's name."""
    return device_memory_stats(device)


def cpu_info() -> Dict[str, Any]:
    """The host CPU's model, logical core count and memory (KiB), where
    ``/proc`` has them."""
    info: Dict[str, Any] = {"logical_cores": os.cpu_count() or 0}
    for path, key, field in (("/proc/cpuinfo", "model name", "model"),
                             ("/proc/meminfo", "MemTotal:", "mem_total_kb")):
        try:
            with open(path, "r") as f:
                for line in f:
                    if line.startswith(key):
                        value = line.partition(":")[2].strip()
                        info[field] = int(value.split()[0]) \
                            if field == "mem_total_kb" else value
                        break
        except OSError:
            pass
    return info


def cpu_topology() -> Dict[str, Any]:
    """Deep host topology (parity: HardwareInfo, hardware_info.hpp:13-168 —
    sockets/cores/threads, P/E core census, cache hierarchy, frequency
    range). ``cpu_info``'s fields plus what /proc and sysfs give; missing
    files simply omit their fields."""
    from . import affinity

    sys_cpu = "/sys/devices/system/cpu"
    cpus = affinity.available_cpus()
    topo: Dict[str, Any] = dict(cpu_info())
    packages, cores = set(), set()
    for c in cpus:
        base = f"{sys_cpu}/cpu{c}/topology"
        pkg = affinity._read_int(f"{base}/physical_package_id")
        core = affinity._read_int(f"{base}/core_id")
        if pkg is not None:
            packages.add(pkg)
        if pkg is not None and core is not None:
            cores.add((pkg, core))
    if packages:
        topo["sockets"] = len(packages)
    if cores:
        topo["physical_cores"] = len(cores)
        topo["threads_per_core"] = round(len(cpus) / len(cores), 2)
    types = affinity.core_types()
    topo["p_cores"] = sum(1 for t in types.values() if t == "P")
    topo["e_cores"] = sum(1 for t in types.values() if t == "E")
    # cache hierarchy of cpu0 (uniform on every machine we care about)
    caches = []
    idx = 0
    while True:
        base = f"{sys_cpu}/cpu{cpus[0] if cpus else 0}/cache/index{idx}"
        if not os.path.isdir(base):
            break
        entry = {}
        for key in ("level", "type", "size"):
            try:
                with open(os.path.join(base, key)) as f:
                    entry[key] = f.read().strip()
            except OSError:
                pass
        if entry:
            caches.append(entry)
        idx += 1
    if caches:
        topo["caches"] = caches
    fmin = affinity._read_int(f"{sys_cpu}/cpu0/cpufreq/cpuinfo_min_freq")
    fmax = affinity._read_int(f"{sys_cpu}/cpu0/cpufreq/cpuinfo_max_freq")
    if fmax:
        topo["freq_khz"] = {"min": fmin or 0, "max": fmax}
    return topo


def _power_limits() -> List[str]:
    """Each card's ``power.limit`` as ``nvidia-smi`` gives it (empty
    where it cannot be read)."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired):
        return []
    return out.stdout.strip().splitlines() if out.returncode == 0 else []


def device_info() -> List[Dict[str, Any]]:
    """One entry per CUDA card: index, name, memory in bytes, SM count,
    compute capability, power limit and this process's index in its
    process group (0 outside one; empty without a card)."""
    if not torch.cuda.is_available():
        return []
    from ..parallel import process_group

    limits = _power_limits()
    out = []
    for i in range(torch.cuda.device_count()):
        props = torch.cuda.get_device_properties(i)
        out.append({"id": i, "platform": "gpu", "kind": props.name,
                    "memory_bytes": int(props.total_memory),
                    "sm_count": int(props.multi_processor_count),
                    "compute_capability": f"{props.major}.{props.minor}",
                    "power_limit": limits[i] if i < len(limits) else "",
                    "process_index": process_group.process_index()})
    return out
