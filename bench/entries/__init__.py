"""The benchmark's entries into the program, one module each, named by a
traffic file's ``entry``: ``run(cell)`` loads, warms up, measures for
``cell.seconds``, checks, and returns the record (see ``bench.harness``).
"""
