"""Minimal colored console logging.

Replaces the reference's termcolor wrapper zoo
(src/utils/console_utils.py:5-114) with three leveled helpers plus the raw
style function.

Carried over unchanged from eincm_tpu/utils/console.py.
"""

from __future__ import annotations

import sys

_STYLES = {
    "bold": "1", "red": "31", "green": "32", "yellow": "33", "blue": "34",
    "magenta": "35", "cyan": "36",
}


def style(text: str, *names: str) -> str:
    if not sys.stdout.isatty():
        return text
    codes = ";".join(_STYLES[n] for n in names if n in _STYLES)
    return f"\033[{codes}m{text}\033[0m" if codes else text


def log(msg: str):
    print(style("[eincm]", "cyan"), msg, flush=True)


def ok(msg: str):
    print(style("[eincm]", "green", "bold"), msg, flush=True)


def warn(msg: str):
    print(style("[eincm][warn]", "yellow", "bold"), msg, flush=True)
