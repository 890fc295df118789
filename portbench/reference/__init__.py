"""The plain reference the correctness check holds the program to."""
