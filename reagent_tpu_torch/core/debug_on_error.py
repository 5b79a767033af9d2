"""Post-mortem debugger hook.

Port of ``reagent_tpu/core/debug_on_error.py`` (reference:
reagent/core/debug_on_error.py).

``start()`` installs a sys.excepthook that drops into pdb post-mortem on any
uncaught exception in interactive sessions; the CLI enables it at startup like
the reference (workflow/cli.py:22-24 there).
"""

from __future__ import annotations

import sys


def start() -> None:
    def info(type_, value, tb):
        if hasattr(sys, "ps1") or not sys.stderr.isatty():
            # interactive mode or no tty: default behavior
            sys.__excepthook__(type_, value, tb)
        else:
            import pdb
            import traceback

            traceback.print_exception(type_, value, tb)
            pdb.post_mortem(tb)

    sys.excepthook = info


def stop() -> None:
    sys.excepthook = sys.__excepthook__
