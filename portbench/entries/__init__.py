"""Entries: one module per entry point of the program a workload file names
(`"entry"`). An entry module has `Cell(ctx)` with `setup()`, `window(seconds)`,
`release()` and `numbers(control=False)`; see entries/common.py.
"""
