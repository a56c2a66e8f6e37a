"""The plain reference the benchmark judges the program by: plain torch in
f32, importing nothing of the program."""
