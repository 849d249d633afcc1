"""Jobs: one module a kind of job (a traffic file's ``job``), each
with a class ``Job`` that makes the inputs from the seed, runs the
program's entry point once a call, runs the staged pass that the spans come
from, counts the work of the roofline, and compares sampled outputs with
the plain reference."""
