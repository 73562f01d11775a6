"""Model families: the Llama weight tree and its step-wise decode
functions, and the BERT/ERNIE encoder."""
