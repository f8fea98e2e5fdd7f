"""Plain PyTorch references that decide ``correct``. They import nothing
of the measured program and take only what the harness makes."""
