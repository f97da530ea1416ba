"""The benchmark's plain reference for LZFSE: Python and NumPy only.

A frozen copy of the port's plain spec layer (its ``base/constants.py``,
``base/errors.py`` and ``spec/{bits,container,fse,lz,tables,vn,weights,
match_find,frontend}.py``, imports made local), which follows the
reference Rust implementation line by line, and ``check.py``, which walks
containers, counts their work and compares a run's outputs.

It imports nothing of the program under test, and takes nothing the
program made: the harness hands it the raw inputs it generated, and the
program's outputs only to judge them.
"""
