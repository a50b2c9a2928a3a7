"""Run a CPU-bound port test at the lowest CPU priority, one at a time.

The port's CPU tests spend minutes in single-threaded PyTorch loops and
eager JAX calls.  Under ``pytest -n 6 --dist loadfile`` the port's test
files land on several workers at once, and some reference tests beside
them are timing-sensitive (process clusters that compare presubmit
digests across runs; they fail beside three or more busy processes).
``low_priority`` therefore

* takes an exclusive lock on one file in the temporary directory, so at
  most one such test runs at a time across all the workers of a run (the
  others wait, idle), and
* runs the test body in a helper thread whose own nice value is raised
  to 19, so a test beside it that needs a core gets it first.  Only that
  thread is lowered: the worker's main thread, and every process it
  spawns later, keep their priority.

The caller's intra-op thread count is carried into the helper thread:
OpenMP keeps it per thread, and a fresh thread would otherwise fan every
op out to all cores.  What the test checks is unchanged.
"""

import fcntl
import functools
import os
import tempfile
import threading

import torch

LOCK_PATH = os.path.join(tempfile.gettempdir(), "hbbft_tpu_torch_tests.lock")


def low_priority(test):
    @functools.wraps(test)
    def run(*args, **kwargs):
        result = {}
        threads = torch.get_num_threads()

        def body():
            torch.set_num_threads(threads)
            # Linux: PRIO_PROCESS with a thread id sets that thread only.
            os.setpriority(os.PRIO_PROCESS, threading.get_native_id(), 19)
            try:
                with open(LOCK_PATH, "a") as lock:
                    fcntl.flock(lock, fcntl.LOCK_EX)  # released when closed
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
