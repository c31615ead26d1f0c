"""The plain reference that decides `correct`: numpy only.

It imports nothing of ma_tpu_torch or of the JAX package and takes nothing
the program made. From the generated genome and reads it works out again
each record's score, the best score within reach of each record, the best
score at each read's true origin and at the other copies of a planted
repeat, and the mapping quality that the reported scores admit.
"""
