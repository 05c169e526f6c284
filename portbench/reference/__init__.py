"""The plain reference: frozen copies of the algorithms, importing
nothing of the program (problem.py; one module an improve method)."""
