"""The benchmark's plain f32 reference: it imports nothing of the program."""
