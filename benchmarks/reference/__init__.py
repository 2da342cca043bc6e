"""Plain references the benchmark judges the program against. They import
torch and numpy only: nothing of the program, nothing of JAX."""
