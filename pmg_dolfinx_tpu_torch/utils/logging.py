"""Logging setup (the spdlog / dolfinx ``init_logging`` analogue).

Port of `pmg_dolfinx_tpu.utils.logging`. Rank-aware: with a process group
up (`parallel.multihost.initialize`) only rank 0 logs at the requested
level by default; the other ranks log warnings and errors only, as the
reference prints its banners from rank 0.
"""

import logging
import sys


def init_logging(level=logging.INFO, all_processes=False):
    """Configure the root logger on stdout; ranks other than 0 get
    WARNING unless ``all_processes``."""
    from ..parallel.multihost import process_index

    if not all_processes and process_index() != 0:
        level = logging.WARNING
    logging.basicConfig(
        stream=sys.stdout,
        level=level,
        format="[%(asctime)s %(name)s %(levelname).1s] %(message)s",
        datefmt="%H:%M:%S",
        force=True,
    )


def get_logger(name="pmg_tpu"):
    return logging.getLogger(name)
