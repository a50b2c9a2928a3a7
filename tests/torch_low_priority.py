"""Run a CPU-bound port test at a lowered CPU priority.

The port's CPU tests spend seconds to minutes in single-threaded PyTorch
loops and eager JAX calls.  Under ``pytest -n 6 --dist loadfile`` the
port's test files land on several workers, and some reference tests
beside them are timing-sensitive (process clusters that compare presubmit
digests across runs; they fail beside several busy processes).
``low_priority`` therefore runs the test body in a helper thread whose
own nice value is raised to :data:`NICE`, so a test beside it that needs
a core gets it first.  Only that thread is lowered: the worker's main
thread, and every process it spawns later, keep their priority.

It takes no lock and does not wait for other workers: a worker that
waited would hold its file (``--dist loadfile``) and run nothing else.
The nice value is moderate, not 19: under the scheduler's weights a
nice-10 thread still gets about a tenth of a contended core, so a port
test keeps moving on a loaded box instead of waiting for the rest of the
suite to end.

The caller's intra-op thread count is carried into the helper thread:
OpenMP keeps it per thread, and a fresh thread would otherwise fan every
op out to all cores.  What the test checks is unchanged.
"""

import functools
import os
import threading

import torch

NICE = 10


def low_priority(test):
    @functools.wraps(test)
    def run(*args, **kwargs):
        result = {}
        threads = torch.get_num_threads()

        def body():
            torch.set_num_threads(threads)
            # Linux: PRIO_PROCESS with a thread id sets that thread only.
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), NICE)
            try:
                result["value"] = test(*args, **kwargs)
            except BaseException as exc:  # re-raised in the test's thread
                result["error"] = exc

        worker = threading.Thread(target=body, name=f"low-priority {test.__name__}")
        worker.start()
        worker.join()
        if "error" in result:
            raise result["error"]
        return result.get("value")

    return run
