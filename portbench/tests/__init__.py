"""CPU tests of the benchmark (card-only cases marked ``gpu``)."""
