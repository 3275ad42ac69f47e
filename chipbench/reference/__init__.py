"""The plain references the benchmark judges the program by."""
