"""PHY blocks on tensors: tables, bits (FEC/CRC), QAM, frame (FFT/EQ/CPE),
AGC and sync; counterparts of the reference's phy/ modules."""
