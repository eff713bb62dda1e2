"""The yardstick: a plain float64 Wilson--Dirac operator and the byte
models and peaks of the rooflines. Imports torch and numpy only."""
