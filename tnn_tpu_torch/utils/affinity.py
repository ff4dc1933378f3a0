"""Thread affinity (``tnn_tpu.utils.affinity``): pin the host's IO and
decode threads away from the threads that feed the card.

Parity: reference ThreadAffinity (include/utils/thread_affinity.hpp:22-158),
which pins worker threads to physical/P cores with P-core/E-core awareness
(CoreType, :22). What the framework pins are its own host threads:
prefetch producers and image-decode workers, so input-pipeline work does
not steal cycles from the thread that launches the step's kernels.

Linux-only (sched_setaffinity); every call degrades to a no-op elsewhere.
Core-type detection uses sysfs cpu_capacity (hybrid ARM) or max-frequency
deltas (Intel hybrid: P cores boost higher than E cores).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional, Sequence

_SYS = "/sys/devices/system/cpu"


def available_cpus() -> List[int]:
    """CPUs this process may run on (respects prior cgroup/affinity limits)."""
    try:
        return sorted(os.sched_getaffinity(0))
    except (AttributeError, OSError):
        return list(range(os.cpu_count() or 1))


def _read_int(path: str) -> Optional[int]:
    try:
        with open(path) as f:
            return int(f.read().strip())
    except (OSError, ValueError):
        return None


def core_types() -> Dict[int, str]:
    """cpu -> "P" | "E" (parity: CoreType, thread_affinity.hpp:22).

    Homogeneous machines report all "P". Detection: sysfs cpu_capacity when
    present, else max-frequency spread (>=20% below top == "E").
    """
    cpus = available_cpus()
    caps: Dict[int, int] = {}
    for c in cpus:
        cap = _read_int(f"{_SYS}/cpu{c}/cpu_capacity")
        if cap is None:
            cap = _read_int(f"{_SYS}/cpu{c}/cpufreq/cpuinfo_max_freq")
        caps[c] = cap if cap is not None else 0
    top = max(caps.values()) if caps else 0
    if top <= 0:
        return {c: "P" for c in cpus}
    return {c: ("P" if caps[c] >= 0.8 * top else "E") for c in cpus}


def pin_current_thread(cpus: Sequence[int]) -> bool:
    """Pin the CALLING thread to ``cpus``. Returns False when unsupported."""
    try:
        os.sched_setaffinity(0, set(int(c) for c in cpus))
        return True
    except (AttributeError, OSError, ValueError):
        return False


def io_cpu_set(reserve_for_compute: Optional[int] = None) -> List[int]:
    """CPUs for IO/decode threads: prefer E cores; on homogeneous machines,
    the tail of the CPU list, leaving ``reserve_for_compute`` (default: half,
    at least 1) leading CPUs to the compute runtime.

    TNN_IO_CPUS overrides explicitly ("4-7" or "4,5,6,7").
    """
    env = os.environ.get("TNN_IO_CPUS", "")
    if env:
        return parse_cpu_list(env)
    cpus = available_cpus()
    if len(cpus) <= 1:
        return cpus
    types = core_types()
    e_cores = [c for c in cpus if types.get(c) == "E"]
    if e_cores:
        return e_cores
    reserve = reserve_for_compute if reserve_for_compute is not None \
        else max(1, len(cpus) // 2)
    reserve = min(reserve, len(cpus) - 1)
    return cpus[reserve:]


def parse_cpu_list(spec: str) -> List[int]:
    """"0-3,8,10-11" -> [0,1,2,3,8,10,11]."""
    out: List[int] = []
    for part in spec.split(","):
        part = part.strip()
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-", 1)
            out.extend(range(int(lo), int(hi) + 1))
        else:
            out.append(int(part))
    return sorted(set(out))


def pin_io_thread() -> bool:
    """Convenience: pin the calling (IO) thread to the IO CPU set, if the
    TNN_PIN_IO env knob is on (default off — pinning is a deployment choice)."""
    if os.environ.get("TNN_PIN_IO", "") not in ("1", "true", "yes"):
        return False
    cpus = io_cpu_set()
    return bool(cpus) and pin_current_thread(cpus)
