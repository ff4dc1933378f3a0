"""Plain references the benchmark judges the program by. They import
torch alone: nothing of the program under test, nor JAX."""
