"""The benchmark's own machinery: what later changes to the program may
not move.

``registry`` finds a cell's configuration, traffic mix, driver and
metric readers by the names in ``BENCHMARK.json``; ``window`` is the
closed-loop window and its arithmetic; ``peaks`` the frozen peaks and
the operation and byte counts; ``trace`` the reduction of a profiler
trace to busy time, copy time, kernel time and idle gaps; ``env`` the
run's environment (cache directories, the card, the import check);
``cell`` runs one cell and builds its result line.

Nothing here imports the program at module level, nor JAX or the JAX
package at all.
"""
