"""Generators: one module a traffic family, named by the traffic files
that use it; each makes its inputs from the seed alone."""
