"""The benchmark's plain reference: closest hit and nearest triangle by
brute force. It imports nothing of the program under test and takes
nothing the program made."""
