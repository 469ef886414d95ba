"""The model families of the benchmark's configurations, one module each
(a configuration's ``model.family`` names it).  Each gives the weight
schema's kinds between the embedding and the final norm,
``block_kinds(m)``, in the program's parameter names and in a fixed
order (the order seeds the weights), and the parameters of the products
one token runs through, the unembedding left out,
``body_params_per_token(m)``."""
