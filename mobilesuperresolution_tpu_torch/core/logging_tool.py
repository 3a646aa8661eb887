"""Process-0 file and console logging (counterpart of
mobilesuperresolution_tpu/core/logging_tool.py).

``LoggingTool(job_dir)`` routes the port's loggers (``msr_torch.*``) to
stdout and to ``<job_dir>/result.log``, each line ``<asctime> <LEVEL>
<message>`` as the JAX package writes it, on the chief process only: the
process index is the process group's rank (parallel/distributed.py), else
the environment's ``RANK`` (torchrun sets it before the group exists),
else 0. The entry points log through ``logging.getLogger(
"msr_torch.<name>")``; a new tool replaces the handlers of the one before,
so a process that runs several entry points writes each job's log to its
own directory.
"""

import logging
import os
import sys

from mobilesuperresolution_tpu_torch.parallel.distributed import is_initialized, process_index

_FORMAT = "%(asctime)s %(levelname)s %(message)s"


class LoggingTool:
    def __init__(self, job_dir=None):
        rank = process_index() if is_initialized() else int(os.environ.get("RANK", "0"))
        self.is_chief = rank == 0
        self.logger = logging.getLogger("msr_torch")
        self.logger.setLevel(logging.INFO)
        self.logger.propagate = False
        self.close()
        if self.is_chief:
            self._add(logging.StreamHandler(sys.stdout))
        if self.is_chief and job_dir is not None:
            os.makedirs(job_dir, exist_ok=True)
            self._add(logging.FileHandler(os.path.join(job_dir, "result.log")))
        if not self.logger.handlers:
            self.logger.addHandler(logging.NullHandler())

    def _add(self, handler):
        handler.setFormatter(logging.Formatter(_FORMAT))
        self.logger.addHandler(handler)

    def close(self):
        """Flush and drop the logger's handlers (the file's too)."""
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
