"""Plain PyTorch references of what the cells' timed paths compute. They
import nothing of the port and take nothing that the port made: every input
comes from the benchmark's own generators."""
