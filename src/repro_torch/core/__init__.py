# Stagewise schedules, the prox surrogate and the N-client simulator.
