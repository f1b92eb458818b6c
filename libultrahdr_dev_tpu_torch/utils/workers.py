"""Host worker-count policy, shared by every threaded host stage.

min(cores, 4), the reference's JobQueue sizing
(the reference's lib/src/ultrahdr.cpp:131-183), overridable per stage
through an environment variable (0/1 = serial). A copy of
libultrahdr_dev_tpu/utils/workers.py.
"""

from __future__ import annotations

import os


def worker_count(env_var: str | None = None) -> int:
    if env_var is not None:
        env = os.environ.get(env_var)
        if env is not None:
            try:
                return max(int(env), 1)
            except ValueError:
                pass
    return min(os.cpu_count() or 1, 4)
