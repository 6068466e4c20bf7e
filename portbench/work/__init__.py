"""The benchmark's frozen work model (see ``model.py``). It imports nothing
of the program under test."""
