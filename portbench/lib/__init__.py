"""The yardstick: traffic, weights, peaks and the run's bookkeeping.

Nothing here imports the program, JAX or the JAX package; the drivers
hand the program what these modules make.
"""
