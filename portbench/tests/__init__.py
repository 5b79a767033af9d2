"""The benchmark's own tests: ``python -m pytest portbench/tests -q`` from the
repository's root.  Tests marked ``cuda`` run on the card only
(``python -m pytest -m cuda portbench/tests -q``) and skip here."""
