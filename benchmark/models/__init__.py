"""Model families: variables, FLOP counts, constructors of the program's
models and bindings to the reference."""
