"""Plain references, one module a configuration kind (a configuration's
``kind`` names its module). They import nothing of the program."""
