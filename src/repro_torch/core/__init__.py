# Stagewise schedules, the prox surrogate, the N-client simulator, and the
# serving steps with the greedy reference decode (core.serving).
