"""The general drivers that traffic files name: each reads its mix's
parameters and a configuration, sets the program up from the seed, drives
its window, and compares with the reference."""
