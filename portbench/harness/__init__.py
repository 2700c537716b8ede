"""The benchmark's general code: spec resolution, inputs, timing, trace
reading, FLOP and byte counts. Nothing here imports JAX or the JAX
package; the program (`repro_torch`) is imported only by the drivers."""
