// Nothing of the tensor-core band products is built on the host.
#pragma once
