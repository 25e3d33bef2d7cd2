"""Logging and misc utilities: the port's own copy of
``dynamic_llava_tpu/utils.py`` (the reference's ``llava/utils.py``)."""

from __future__ import annotations

import logging
import logging.handlers
import os

from .constants import LOGDIR

server_error_msg = (
    "**NETWORK ERROR DUE TO HIGH TRAFFIC. PLEASE REGENERATE OR REFRESH THIS PAGE.**"
)
moderation_msg = (
    "YOUR INPUT VIOLATES OUR CONTENT MODERATION GUIDELINES. PLEASE TRY AGAIN."
)

handler = None


def build_logger(logger_name: str, logger_filename: str) -> logging.Logger:
    """Console + rotating-file logger shared across serving processes."""
    global handler

    formatter = logging.Formatter(
        fmt="%(asctime)s | %(levelname)s | %(name)s | %(message)s",
        datefmt="%Y-%m-%d %H:%M:%S",
    )

    root = logging.getLogger()
    if not root.handlers:
        logging.basicConfig(level=logging.INFO)
    for h in root.handlers:
        h.setFormatter(formatter)

    logger = logging.getLogger(logger_name)
    logger.setLevel(logging.INFO)

    if handler is None:
        os.makedirs(LOGDIR, exist_ok=True)
        filename = os.path.join(LOGDIR, logger_filename)
        handler = logging.handlers.TimedRotatingFileHandler(
            filename, when="D", utc=True, encoding="utf-8"
        )
        handler.setFormatter(formatter)
        for item in logging.root.manager.loggerDict.values():
            if isinstance(item, logging.Logger):
                item.addHandler(handler)
    logger.addHandler(handler)
    return logger


def pretty_print_semaphore(semaphore) -> str:
    if semaphore is None:
        return "None"
    return f"Semaphore(value={semaphore._value}, locked={semaphore.locked()})"


def violates_moderation(text: str) -> bool:
    """Moderation hook: disabled, as in the JAX package (the reference
    calls an online moderation API, and this build has no network)."""
    return False
