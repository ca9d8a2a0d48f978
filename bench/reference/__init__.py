"""Plain PyTorch references of the benchmark's configurations.  They
import nothing of the program under test and read only the weights and
token ids the benchmark made."""
