"""The plain reference of the benchmark's cells, in NumPy.

``gate`` follows a stream through a ScaleGate merge and the epoch
protocol (paper §2.4, §5, Alg. 4-6): which tuples each tick releases, the
tick each reconfiguration switches at, and each instance's load.
``wordcount`` counts words per key over sliding windows, ``bandjoin``
joins two streams on a band over a time window.  Nothing here imports the
port: the reference works from the inputs the benchmark made.
"""
