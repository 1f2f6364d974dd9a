"""Plain references that decide ``correct``. They import nothing of the
port and work out again, from the benchmark's own inputs, whatever the
port derived."""
