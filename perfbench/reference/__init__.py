"""Plain references the benchmark judges the program's answers against.
They import nothing of the program and take nothing it made."""
