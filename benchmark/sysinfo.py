"""System banner — runtime/OS/CPU/memory/accelerator topology.

Reference counterpart: benchmark/src/base/sysInfo.js:4-26, extended with the
accelerator topology the reference has no concept of.
"""

from __future__ import annotations

import os
import platform
import sys


def sysinfo(include_devices: bool = True) -> dict:
    info = {
        "python": sys.version.split()[0],
        "platform": platform.platform(),
        "machine": platform.machine(),
        "cpus": os.cpu_count(),
    }
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal"):
                    info["mem_gb"] = round(
                        int(line.split()[1]) / 1e6, 1)
                    break
    except OSError:
        pass
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("model name"):
                    info["cpu"] = line.split(":", 1)[1].strip()
                    break
    except OSError:
        pass
    if include_devices:
        try:
            import jax
            devs = jax.devices()
            info["accelerator"] = {
                "platform": devs[0].platform,
                "device_kind": getattr(devs[0], "device_kind", "?"),
                "local_devices": len(devs),
                "process_count": jax.process_count(),
            }
        except Exception as e:  # pragma: no cover
            info["accelerator"] = f"unavailable: {e!r}"
    return info


def banner() -> str:
    info = sysinfo()
    acc = info.get("accelerator", {})
    acc_s = (f"{acc.get('platform')}/{acc.get('device_kind')} "
             f"x{acc.get('local_devices')}" if isinstance(acc, dict) else acc)
    return (f"divortio_lz4 bench | py {info['python']} | "
            f"{info.get('cpu', info['machine'])} x{info['cpus']} | "
            f"{info.get('mem_gb', '?')} GB | {acc_s}")


if __name__ == "__main__":
    print(banner())
