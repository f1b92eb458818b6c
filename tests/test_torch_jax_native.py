"""The JAX package's native host codec, built and loaded once per test
worker before any test runs.

libultrahdr_dev_tpu/jpeg/native compiles its C++ sources on first use
into one shared object, every process through the same temporary file.
When several pytest-xdist workers build at once, one of them can load a
half-written object; its loader then keeps None for the rest of that
worker, whose JAX host routes (parse_device_stream, the native Huffman
and pack entry points) return None or skip. The port's tests compare
with those routes, so importing this module builds and loads the
library under an exclusive lock on a file beside the object: the build
runs once, and every worker loads the finished file. xdist workers
import every test module while collecting, before any test runs, and
the port's test modules that compare with the JAX host routes import
this one."""

import fcntl
import os

from libultrahdr_dev_tpu.jpeg import native


def load_jax_native():
    """The JAX package's native library, loaded in this process under
    the lock; a load that failed on a half-written object is retried
    once no other process is writing it."""
    with open(native._SO + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        for _ in range(2):
            try:
                lib = native.get_lib()
            except OSError:   # a truncated object from an interrupted build
                lib = None
                if os.path.exists(native._SO):
                    os.remove(native._SO)
            if lib is not None:
                return lib
            native._tried = False
        return None


LIB = load_jax_native()


def test_jax_native_library_loaded():
    assert LIB is not None and native.get_lib() is LIB
