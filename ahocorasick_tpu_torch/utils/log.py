"""Tracing/diagnostics, the analog of the reference's `logging` feature.

The reference gates `debug!`/`trace!` macros behind a cargo feature
(src/macros.rs:1-18, Cargo.toml:27-30) and uses them to trace backend
selection, build sizes and prefilter choice. Here the standard library
logger ``ahocorasick_tpu_torch`` plays that role: silent unless the
embedding application configures logging (the no-op-by-default contract).

    import logging
    logging.getLogger("ahocorasick_tpu_torch").setLevel(logging.DEBUG)
"""

import logging

logger = logging.getLogger("ahocorasick_tpu_torch")


def debug(msg: str, *args) -> None:
    if logger.isEnabledFor(logging.DEBUG):
        logger.debug(msg, *args)


def trace(msg: str, *args) -> None:
    # TRACE maps to a level below DEBUG, as in the reference.
    if logger.isEnabledFor(5):
        logger.log(5, msg, *args)
