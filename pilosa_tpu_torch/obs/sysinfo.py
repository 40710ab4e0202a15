"""System information (reference: gopsutil/ SystemInfo — uptime,
platform, memory; server.go:793-835 monitorRuntime feeds it into stats).

Counterpart of ``pilosa_tpu/obs/sysinfo.py``. Everything reads /proc
directly (Linux-only, graceful zeros elsewhere) plus the CUDA device
inventory from ``torch.cuda``: name, memory and count, with the torch and
CUDA versions in the build and process blocks. :class:`GCNotifier` and
:class:`RuntimeMonitor` publish the runtime gauges under JAX's names.
"""

from __future__ import annotations

import os
import platform
import threading
import time

# fallback process start time where /proc is unavailable
_IMPORT_TIME = time.time()


def _torch_versions() -> tuple[str, str]:
    """(torch version, the CUDA version torch was built for; "" for a
    CPU build)."""
    import torch

    return torch.__version__, torch.version.cuda or ""


def build_info_text(version: str) -> str:
    """Prometheus ``build_info`` exposition block (the node_exporter
    idiom: a constant 1-valued gauge whose labels carry the versions)."""
    torch_version, cuda_version = _torch_versions()
    py = platform.python_version()
    return (
        "# HELP pilosa_build_info build/version identity "
        "(constant 1; labels carry the versions)\n"
        "# TYPE pilosa_build_info gauge\n"
        f'pilosa_build_info{{version="{version}",torch="{torch_version}",'
        f'cuda="{cuda_version}",python="{py}"}} 1\n'
    )


class SystemInfo:
    """reference gopsutil/gopsutil.go systemInfo."""

    _boot_time: float | None = None

    def uptime(self) -> int:
        """Seconds since host boot (reference Uptime)."""
        try:
            with open("/proc/uptime") as f:
                return int(float(f.read().split()[0]))
        except OSError:
            return 0

    def platform(self) -> str:
        return platform.system().lower()

    def family(self) -> str:
        return platform.machine()

    def os_version(self) -> str:
        return platform.release()

    def kernel_version(self) -> str:
        return platform.version()

    def _meminfo(self) -> dict[str, int]:
        out: dict[str, int] = {}
        try:
            with open("/proc/meminfo") as f:
                for line in f:
                    key, _, rest = line.partition(":")
                    val = rest.split()
                    if val:
                        out[key] = int(val[0]) * 1024  # kB -> bytes
        except OSError:
            pass
        return out

    def mem_total(self) -> int:
        return self._meminfo().get("MemTotal", 0)

    def mem_free(self) -> int:
        m = self._meminfo()
        return m.get("MemAvailable", m.get("MemFree", 0))

    def mem_used(self) -> int:
        m = self._meminfo()
        total = m.get("MemTotal", 0)
        return total - m.get("MemAvailable", m.get("MemFree", 0)) if total else 0

    def cpu_count(self) -> int:
        return os.cpu_count() or 0

    def thread_count(self) -> int:
        """Live Python threads — the goroutine-count analogue."""
        return threading.active_count()

    def process_rss(self) -> int:
        """Resident set size of this process in bytes."""
        try:
            with open("/proc/self/statm") as f:
                pages = int(f.read().split()[1])
            return pages * os.sysconf("SC_PAGE_SIZE")
        except (OSError, ValueError):
            return 0

    def process_start_time(self) -> float:
        """Unix time this PROCESS started (the host ``uptime`` above is
        boot time, not ours).  /proc/self/stat field 22 is start time
        in clock ticks since boot; boot time is /proc/stat ``btime``.
        Falls back to module-import time off Linux."""
        try:
            with open("/proc/self/stat") as f:
                # comm (field 2) may contain spaces; split after the
                # closing paren so field indices stay stable
                rest = f.read().rsplit(")", 1)[1].split()
            ticks = float(rest[19])  # field 22, 0-indexed after comm
            with open("/proc/stat") as f:
                for line in f:
                    if line.startswith("btime "):
                        btime = float(line.split()[1])
                        break
                else:
                    return _IMPORT_TIME
            return btime + ticks / os.sysconf("SC_CLK_TCK")
        except (OSError, ValueError, IndexError):
            return _IMPORT_TIME

    def process_uptime(self) -> float:
        """Seconds since this process started."""
        return max(0.0, time.time() - self.process_start_time())

    def process_block(self, version: str = "") -> dict:
        """The ``process`` block for /debug/vars: this process's own
        identity and age, distinct from the host report above."""
        torch_version, cuda_version = _torch_versions()
        return {
            "pid": os.getpid(),
            "version": version,
            "python": platform.python_version(),
            "torch": torch_version,
            "cuda": cuda_version,
            "startTime": self.process_start_time(),
            "uptimeSeconds": round(self.process_uptime(), 3),
            "rssBytes": self.process_rss(),
            "threads": self.thread_count(),
        }

    def devices(self) -> list[dict]:
        """CUDA device inventory: index, name, memory and the SM count of
        every card torch sees (empty where CUDA is missing)."""
        import torch

        if not torch.cuda.is_available():
            return []
        out = []
        for i in range(torch.cuda.device_count()):
            p = torch.cuda.get_device_properties(i)
            out.append({
                "id": i,
                "kind": p.name,
                "platform": "gpu",
                "memoryBytes": int(p.total_memory),
                "multiProcessors": int(p.multi_processor_count),
            })
        return out

    def to_dict(self) -> dict:
        m = self._meminfo()
        total = m.get("MemTotal", 0)
        free = m.get("MemAvailable", m.get("MemFree", 0))
        return {
            "uptime": self.uptime(),
            "platform": self.platform(),
            "family": self.family(),
            "osVersion": self.os_version(),
            "kernelVersion": self.kernel_version(),
            "memTotal": total,
            "memFree": free,
            "memUsed": total - free if total else 0,
            "cpuCount": self.cpu_count(),
            "threadCount": self.thread_count(),
            "processRSS": self.process_rss(),
            "devices": self.devices(),
        }


class GCNotifier:
    """GC → stats bridge (reference gcnotify/ + server.go:826-833:
    a channel that ticks after every garbage collection, counted into
    the stats client). Uses CPython's gc callback hook.

    The callback itself only bumps a bare int: CPython invokes
    gc.callbacks synchronously on WHATEVER thread triggered collection,
    possibly while that thread already holds the stats client's
    non-reentrant lock (e.g. mid-snapshot) — calling into the client
    here would self-deadlock. RuntimeMonitor publishes the counter as a
    gauge instead.

    gc.callbacks is process-global, so the registered hook holds only a
    weakref: a notifier dropped without close() unregisters itself on the
    next collection instead of pinning its owner for the process
    lifetime."""

    def __init__(self):
        import gc
        import weakref

        self._gc = gc
        self.collections = 0

        ref = weakref.ref(self)

        def _cb(phase: str, info: dict, _ref=ref, _gc=gc) -> None:
            self_ = _ref()
            if self_ is None:
                try:
                    _gc.callbacks.remove(_cb)
                except ValueError:
                    pass
                return
            if phase == "stop":
                self_.collections += 1  # plain int bump: no locks, no allocation

        self._cb = _cb
        gc.callbacks.append(_cb)

    def close(self) -> None:
        try:
            self._gc.callbacks.remove(self._cb)
        except ValueError:
            pass


class RuntimeMonitor:
    """Periodic runtime-metrics gauge loop (reference server.go:793-835
    monitorRuntime: heap/goroutines/open-files into stats)."""

    def __init__(self, stats_client, interval: float = 10.0, gc_notifier=None):
        self.stats = stats_client
        self.interval = interval
        self.gc_notifier = gc_notifier
        self.info = SystemInfo()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def poll_once(self) -> None:
        self.stats.gauge("memory_rss_bytes", self.info.process_rss())
        self.stats.gauge("threads", self.info.thread_count())
        self.stats.gauge("host_mem_free_bytes", self.info.mem_free())
        self.stats.gauge(
            "process_uptime_seconds", round(self.info.process_uptime(), 3)
        )
        self.stats.gauge(
            "process_start_time_seconds", self.info.process_start_time()
        )
        if self.gc_notifier is not None:
            self.stats.gauge("garbage_collections", self.gc_notifier.collections)

    def start(self) -> None:
        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.poll_once()
                except Exception:
                    # keep polling; a failed sample is itself a metric
                    self.stats.count("metric_poll_errors", 1)

        self._thread = threading.Thread(target=run, name="runtime-monitor", daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=5.0)
        self._thread = None
